// Contraction of the Contiger's chain forest (kernel K9): the head and the
// distance from it of every oriented node, the reverse complement of every
// node k-mer, and the mirror keep rule.
//
// Replaces, where the forest lies on the card, the host steps that the JAX
// package runs after its probe programs (sh_assembly_tpu/models/contiger.py:
// the native walk of cpp/contract.cpp, its device form contract_paths, the
// numpy revcomp_packed of kmerpack_np and the numpy mirror keep rule of
// finalize_unitigs).  The results are theirs, bit for bit:
//   head[a]  the first node of a's path; on a cycle its least index
//   dist[a]  the steps from head[a] to a
//   keep[a]  a is a head, and its oriented k-mer is <= (unsigned,
//            lexicographic on (hi, lo)) the oriented k-mer of its mirror's
//            head, tail_of[a] ^ 1, where tail_of[a] is the last node of a's
//            path (on a cycle the node whose next is the head)
//   rhi, rlo the reverse complement of each node's left-aligned k-mer.
// Chain targets are unique (the indeg-1 rule of build_oriented_graph), so
// the forest is pure paths and pure cycles.  A target out of range or
// shared by two nodes is counted in `bad`; the other outputs mean nothing
// where it is not 0, and every walk stops within M steps whatever the input.
//
// How: a sparse ruling set.  Oriented node indices are cut into aligned
// blocks of S = 32; in each block one node, at an offset a hash of the block
// picks, is a splitter, and so is every root (a node with no predecessor).
//   1. k_scatter   prev[] from next[] (an atomicCAS a target: a second
//                  source is a fault)
//   2. k_segments  every splitter walks to the next splitter, writing its
//                  own code and the local offset into head[]/dist[] of each
//                  node it passes; a root's code is the root (final), a
//                  sampled splitter's its block's slot ~j.  At the next
//                  splitter it leaves (its code, the segment's length) in
//                  that one's slot, and its own segment's least node.
//   3. k_jump      pointer jumping over the slots (R = M / S of them):
//                  offsets add up towards the root, least nodes fold in.
//   4. k_cut       slots that reached no root lie on cycles; the slot whose
//                  segment holds the cycle's least node m restarts the
//                  ranking from m, and
//   5. k_jump      ranks the cycles' slots again.
//   6. k_final     each node adds its slot's offset (on a cycle, modulo the
//                  cycle's length, from m) and scatters tail_of[head] = a for
//                  the tails.  A cycle with no sampled node, rare and short
//                  for a hash that knows nothing of the forest, is walked by
//                  its nodes until one meets a smaller index; its least node
//                  goes round once more writing it.
//   7. k_revcomp   one thread a node: its reverse complement.
//   8. k_keep      one thread a node: both orientations' keep rule.
// A walk takes S steps on average and about S ln(M / S) at the most; the
// rounds are ceil(log2 R) twice, over R slots.  Indices are int32.
// What bounds it on an H100: the walks' dependent loads of next[] (4-byte
// random reads, each a 32-byte sector) and the scattered stores; no thread
// walks more than a segment, so the card's many warps hide the latency.
// The bytes that must move (next read, head, dist and keep written, the
// node words read and their reverse complements written) are 29 an
// oriented node.

#include <climits>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int NT = 256;     // threads a block
constexpr int S_LOG = 5;    // a splitter every S nodes, on average
constexpr int S = 1 << S_LOG;
constexpr int UNVISITED = INT_MIN;  // head[] of a node no segment passed
constexpr int INACTIVE = INT_MIN;   // a slot whose node is a root or absent

// Slot arrays, int32 each, in one buffer of R entries a row: two sets of
// (pred, offset, least) for the rounds, the segments' own pred and length,
// their least node, and the cycle cut's offset of m.
enum { P0, A0, L0, P1, A1, L1, PRED, LEN, SMIN, CUT, SLOT_ROWS };

__device__ __forceinline__ unsigned mix32(unsigned h) {
  h ^= h >> 16;
  h *= 0x7feb352du;
  h ^= h >> 15;
  h *= 0x846ca68bu;
  h ^= h >> 16;
  return h;
}

// Whether a is its block's sampled splitter.
__device__ __forceinline__ bool sampled(int a) {
  return (unsigned)(a & (S - 1)) == (mix32((unsigned)a >> S_LOG) & (S - 1));
}

__device__ __forceinline__ long long gid() {
  return (long long)blockIdx.x * NT + threadIdx.x;
}

// Reverse the 32 2-bit groups of a word.
__device__ __forceinline__ u64 rev2(u64 x) {
  x = __brevll(x);
  return ((x >> 1) & 0x5555555555555555ull) |
         ((x & 0x5555555555555555ull) << 1);
}

__global__ void __launch_bounds__(NT)
    k_scatter(const int* __restrict__ next, int M, int* __restrict__ prev,
              int* __restrict__ head, int R, int* __restrict__ pred,
              int* __restrict__ bad) {
  const long long i = gid();
  if (i >= M) return;
  const int a = (int)i;
  head[a] = UNVISITED;
  if (a < R) pred[a] = INACTIVE;
  const int b = next[a];
  if (b < 0) return;
  if (b >= M || atomicCAS(&prev[b], -1, a) != -1) atomicAdd(bad, 1);
}

__global__ void __launch_bounds__(NT)
    k_segments(const int* __restrict__ next, const int* __restrict__ prev,
               int M, int* __restrict__ head, int* __restrict__ dist,
               int* __restrict__ p_run, unsigned* __restrict__ a_run,
               int* __restrict__ l_run, int* __restrict__ p_seg,
               unsigned* __restrict__ a_seg, int* __restrict__ smin,
               int* __restrict__ bad) {
  const long long i = gid();
  if (i >= M) return;
  const int a = (int)i;
  const bool root = prev[a] < 0;
  if (!root && !sampled(a)) return;
  const int code = root ? a : ~(a >> S_LOG);  // what the nodes passed hold
  const int from = root ? ~a : a >> S_LOG;    // the next slot's pred
  int x = a, least = a, d = 0;
  for (;;) {
    head[x] = code;
    dist[x] = d++;
    least = min(least, x);
    const int y = next[x];
    if (y < 0 || y >= M) break;
    if (sampled(y)) {  // a chain target is never a root
      const int t = y >> S_LOG;
      p_run[t] = p_seg[t] = from;
      a_run[t] = a_seg[t] = (unsigned)d;
      break;
    }
    if (d == M) {  // only a malformed forest walks on
      atomicAdd(bad, 1);
      break;
    }
    x = y;
  }
  if (!root) l_run[a >> S_LOG] = smin[a >> S_LOG] = least;
}

// One round: each slot adds its pred's offset and least node and takes its
// pred's pred, until the pred is a root (a negative code).
__global__ void __launch_bounds__(NT)
    k_jump(int R, const int* __restrict__ sp, const unsigned* __restrict__ sa,
           const int* __restrict__ sl, int* __restrict__ dp,
           unsigned* __restrict__ da, int* __restrict__ dl) {
  const long long i = gid();
  if (i >= R) return;
  const int j = (int)i;
  int p = sp[j];
  unsigned off = sa[j];
  int least = sl[j];
  if (p >= 0) {
    off += sa[p];
    least = min(least, sl[p]);
    p = sp[p];
  }
  dp[j] = p;
  da[j] = off;
  dl[j] = least;
}

// Slots still pointing at a slot lie on a cycle, and their least node is
// the cycle's, m: the slot whose segment holds m takes m as its root, at
// offset 0, and every other slot of the cycle takes its segment's pred and
// length back for the second ranking.
__global__ void __launch_bounds__(NT)
    k_cut(int R, int* __restrict__ cp, unsigned* __restrict__ ca,
          const int* __restrict__ cl, const int* __restrict__ p_seg,
          const unsigned* __restrict__ a_seg, const int* __restrict__ smin,
          const int* __restrict__ dist, int* __restrict__ cut) {
  const long long i = gid();
  if (i >= R) return;
  const int j = (int)i;
  const int p = cp[j];
  if (p == INACTIVE) return;
  if (p < 0) {  // a path's slot, ranked
    cut[j] = -1;
    return;
  }
  const int m = cl[j];
  cut[j] = dist[m];  // m's offset in its own segment
  const bool at_m = smin[j] == m;
  cp[j] = at_m ? ~m : p_seg[j];
  ca[j] = at_m ? 0u : a_seg[j];
}

__global__ void __launch_bounds__(NT)
    k_final(const int* __restrict__ next, int M, int* __restrict__ head,
            int* __restrict__ dist, const int* __restrict__ fp,
            const unsigned* __restrict__ fa, const int* __restrict__ p_seg,
            const unsigned* __restrict__ a_seg, const int* __restrict__ cut,
            int* __restrict__ tail_of, int* __restrict__ bad) {
  const long long i = gid();
  if (i >= M) return;
  const int x = (int)i;
  int h = head[x];
  const int nx = next[x];
  if (h == UNVISITED) {
    // a cycle with no splitter: only its least node finds no smaller one
    // on its way round, and then writes the cycle
    int y = nx, steps = 0;
    while (y != x) {
      if (y < x || y >= M || ++steps == M) return;
      y = next[y];
    }
    int z = x, d = 0;
    do {
      head[z] = x;
      dist[z] = d++;
      const int nz = next[z];
      if (nz == x) tail_of[x] = z;
      z = nz;
    } while (z != x);
    return;
  }
  if (h < 0) {
    const int j = ~h;
    h = ~fp[j];
    int d = (int)(fa[j] + (unsigned)dist[x]);
    const int o = cut[j];
    if (o >= 0) {  // on a cycle: from m, modulo the cycle's length
      d -= o;
      if (d < 0) d += (int)(fa[p_seg[j]] + a_seg[j]);
    }
    if ((unsigned)h >= (unsigned)M) {  // only a malformed forest
      atomicAdd(bad, 1);
      return;
    }
    head[x] = h;
    dist[x] = d;
  }
  if (nx < 0 || nx >= M || nx == h) tail_of[h] = x;
}

__global__ void __launch_bounds__(NT)
    k_revcomp(const u64* __restrict__ hi, const u64* __restrict__ lo, int n,
              int k, u64* __restrict__ rhi, u64* __restrict__ rlo) {
  const long long i = gid();
  if (i >= n) return;
  // kmerpack.revcomp_packed: complement, reverse, re-left-align
  const u64 a = rev2(~lo[i]), b = rev2(~hi[i]);
  const int sh = 128 - 2 * k;
  u64 rh, rl;
  if (sh == 0) {
    rh = a;
    rl = b;
  } else if (sh < 64) {
    rh = (a << sh) | (b >> (64 - sh));
    rl = b << sh;
  } else if (sh == 64) {
    rh = b;
    rl = 0;
  } else {
    rh = b << (sh - 64);
    rl = 0;
  }
  rhi[i] = rh;
  rlo[i] = rl;
}

// Node i's two orientations a = 2i + o: keep[a] (one byte each, written as
// one 16-bit word).
__global__ void __launch_bounds__(NT)
    k_keep(const u64* __restrict__ hi, const u64* __restrict__ lo,
           const u64* __restrict__ rhi, const u64* __restrict__ rlo, int n,
           const int* __restrict__ head, const int* __restrict__ tail_of,
           unsigned short* __restrict__ keep) {
  const long long i = gid();
  if (i >= n) return;
  unsigned out = 0;
  for (int o = 0; o < 2; ++o) {
    const int a = 2 * (int)i + o;
    if (head[a] != a) continue;
    const int t = tail_of[a];
    if ((unsigned)t >= 2u * (unsigned)n) continue;  // only a malformed forest
    const int m = t ^ 1, mi = m >> 1;
    const u64 mh = (m & 1) ? rhi[mi] : hi[mi];
    const u64 ml = (m & 1) ? rlo[mi] : lo[mi];
    const u64 oh = o ? rhi[i] : hi[i], ol = o ? rlo[i] : lo[i];
    if (oh < mh || (oh == mh && ol <= ml)) out |= 1u << (8 * o);
  }
  keep[i] = (unsigned short)out;
}

unsigned blocks(long long n) { return (unsigned)((n + NT - 1) / NT); }

}  // namespace

extern "C" {

// Slots a forest of M oriented nodes needs, and int32 entries of scratch:
// SLOT_ROWS rows of them.
int contract_slots(int M) { return (M + S - 1) / S; }
int contract_slot_rows() { return SLOT_ROWS; }

// Launch the ranking on `stream`: next int32[M] (-1 = none) -> head and
// dist int32[M], tail_of int32[M] (at each head, the last node of its path;
// elsewhere scratch), bad int32[1] (targets out of range or shared);
// slots: int32[SLOT_ROWS * contract_slots(M)] of scratch.  Returns the CUDA
// error of the first call that failed (0 = none).
int contract_rank_launch(const void* next, int M, void* head, void* dist,
                         void* tail_of, void* slots, void* bad,
                         void* stream) {
  if (M <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const int* nx = (const int*)next;
  int* hd = (int*)head;
  int* ds = (int*)dist;
  int* prev = (int*)tail_of;  // prev[] until k_final makes it tail_of[]
  int* nb = (int*)bad;
  int R = contract_slots(M);
  int* row[SLOT_ROWS];
  for (int r = 0; r < SLOT_ROWS; ++r) row[r] = (int*)slots + (long long)r * R;
  int* P[2] = {row[P0], row[P1]};
  unsigned* A[2] = {(unsigned*)row[A0], (unsigned*)row[A1]};
  int* L[2] = {row[L0], row[L1]};
  unsigned* a_seg = (unsigned*)row[LEN];
  int rounds = 0;
  while ((1LL << rounds) < R) ++rounds;

  cudaError_t e = cudaMemsetAsync(prev, 0xFF, (size_t)M * sizeof(int), st);
  if (e == cudaSuccess) e = cudaMemsetAsync(nb, 0, sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  // cudaLaunchKernel returns this launch's own error, where
  // cudaGetLastError would also report an earlier call's
  {
    void* args[] = {&nx, &M, &prev, &hd, &R, &P[0], &nb};
    e = cudaLaunchKernel(k_scatter, dim3(blocks(M)), dim3(NT), args, 0, st);
    if (e != cudaSuccess) return (int)e;
  }
  {
    void* args[] = {&nx,   &prev,      &M,     &hd,        &ds,
                    &P[0], &A[0],      &L[0],  &row[PRED], &a_seg,
                    &row[SMIN], &nb};
    e = cudaLaunchKernel(k_segments, dim3(blocks(M)), dim3(NT), args, 0,
                         st);
    if (e != cudaSuccess) return (int)e;
  }
  int cur = 0;
  for (int pass = 0; pass < 2; ++pass) {
    for (int r = 0; r < rounds; ++r, cur ^= 1) {
      void* args[] = {&R,       &P[cur],     &A[cur],    &L[cur],
                      &P[cur ^ 1], &A[cur ^ 1], &L[cur ^ 1]};
      e = cudaLaunchKernel(k_jump, dim3(blocks(R)), dim3(NT), args, 0, st);
      if (e != cudaSuccess) return (int)e;
    }
    if (pass == 0) {
      void* args[] = {&R,     &P[cur],     &A[cur],   &L[cur], &row[PRED],
                      &a_seg, &row[SMIN],  &ds,       &row[CUT]};
      e = cudaLaunchKernel(k_cut, dim3(blocks(R)), dim3(NT), args, 0, st);
      if (e != cudaSuccess) return (int)e;
    }
  }
  void* args[] = {&nx,        &M,     &hd,       &ds,   &P[cur], &A[cur],
                  &row[PRED], &a_seg, &row[CUT], &prev, &nb};
  return (int)cudaLaunchKernel(k_final, dim3(blocks(M)), dim3(NT), args, 0,
                               st);
}

// Launch the reverse complements on `stream`: hi, lo u64[n] -> rhi, rlo
// u64[n]; 1 <= k <= 63.
int contract_revcomp_launch(const void* hi, const void* lo, int n, int k,
                            void* rhi, void* rlo, void* stream) {
  if (n <= 0) return 0;
  if (k < 1 || k > 63) return (int)cudaErrorInvalidValue;
  void* args[] = {&hi, &lo, &n, &k, &rhi, &rlo};
  return (int)cudaLaunchKernel(k_revcomp, dim3(blocks(n)), dim3(NT), args,
                               0, (cudaStream_t)stream);
}

// Launch the keep rule on `stream`: n nodes' words and reverse complements,
// head and tail_of int32[2n] from the ranking -> keep, 2n bytes (0 or 1).
int contract_keep_launch(const void* hi, const void* lo, const void* rhi,
                         const void* rlo, int n, const void* head,
                         const void* tail_of, void* keep, void* stream) {
  if (n <= 0) return 0;
  void* args[] = {&hi, &lo, &rhi, &rlo, &n, &head, &tail_of, &keep};
  return (int)cudaLaunchKernel(k_keep, dim3(blocks(n)), dim3(NT), args, 0,
                               (cudaStream_t)stream);
}

}  // extern "C"
