// Placement of the kept paths' members (kernel K10): every member of every
// kept oriented path, in (head, dist) order, with what the host assembly
// reads of it.
//
// Replaces, where the contraction's forest lies on the card, the members
// step of the host assembly (in the JAX package the first lines of
// _finalize_host, sh_assembly_tpu/models/contiger.py): a mask of
// the oriented nodes down to the members of kept paths (keep[head[a]] and
// real[a >> 1]), np.lexsort by (head, dist), and gathers of the oriented
// words, the last bases and the counts in that order.  The results are
// theirs, bit for bit:
//   ai[i]             the i-th member's oriented index
//   ohi[i], olo[i]    its oriented k-mer: the node's words (hi, lo) where
//                     ai is even, their reverse complements (rhi, rlo)
//                     where it is odd
//   lastb[i]          the last base of that k-mer (kmerpack_np.last_base)
//   counts[i]         node_counts[ai >> 1]
//   starts[p]         the first member of the p-th path, paths in the
//                     index order of their heads
//   head_idx[p]       that path's head.
//
// Why no sort: K9 (contract.cu) leaves on the card head[a], the first node
// of a's path, and dist[a], a's steps from it, 0 .. len - 1 and unique
// within the path (cycles cut at their least index); and tail_of[h], at
// each head, the path's last node.  keep is true at heads only.  So a kept
// head h of a real node heads cnt[h] = dist[tail_of[h]] + 1 members, and a
// member a lands at
//   off[head[a]] + dist[a],   off = the exclusive scan of cnt in index order.
// The lexsort's order is exactly that.  Padding rows lie on no real node's
// path (build_oriented_graph gives them no edge); a path that broke this
// would be counted: a padding row inside a counted path, or a real node on
// a padding row's kept path, adds to `bad`, and the members placed then
// differ from the scan's total.
//
// How, over the M = 2 Np oriented slots, in tiles of TILE = NT * ITEMS
// slots (a thread ITEMS of them in a row, its keep bytes as one 16-byte
// load: kept heads are sparse, so most threads read nothing else):
//   1. k_count    each tile's pair (members, counted heads) -> bsum;
//   2. k_carry    one block scans the tiles' pairs (exclusive, in place)
//                 and writes the totals (M_mem, P);
//      the host reads the totals and sizes the outputs;
//   3. k_offsets  each tile again: a block scan of its threads' pairs from
//                 the tile's carry; every counted head h writes off[h],
//                 starts[pid] and head_idx[pid]; every other slot -1;
//   4. k_place    a thread an oriented node a: where off[head[a]] >= 0 and
//                 a is real, it writes its member row at off + dist[a] and
//                 counts itself in `placed`; one add a block for each
//                 counter, no other atomics.
// What bounds it on an H100: k_place's reads of off[head[a]] and of the
// member's node words, and its five scattered stores a member (a member's
// place is random against its index); every other access is coalesced.
// The bytes that must move: keep, head, dist read and off written and read
// (17 B an oriented slot), real read (1 B a node), and per member its
// words and count read and its 25-byte row written (45 B).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int NT = 256;                 // threads a block
constexpr int ITEMS = 16;               // slots a thread (one 16-byte load)
constexpr int TILE = NT * ITEMS;        // slots a block
constexpr int WARPS = NT / 32;
constexpr int CARRY_NT = 1024;          // k_carry's one block
constexpr int CARRY_WARPS = CARRY_NT / 32;

__device__ __forceinline__ long long gid() {
  return (long long)blockIdx.x * blockDim.x + threadIdx.x;
}

// Members of the path headed at h: 0 where h is no kept head of a real node
// (and, in a malformed forest only, where its tail is out of range).
__device__ __forceinline__ int count_at(int h, const unsigned char* real,
                                        const int* __restrict__ dist,
                                        const int* __restrict__ tail_of,
                                        int M) {
  if (!real[h >> 1]) return 0;
  const int t = tail_of[h];
  if ((unsigned)t >= (unsigned)M) return 0;
  const int d = dist[t];
  return d >= 0 ? d + 1 : 0;
}

// A thread's ITEMS slots from `base`: their counts into c[], their sum and
// the heads counted.
__device__ __forceinline__ void thread_counts(
    long long base, int M, const unsigned char* __restrict__ keep,
    const unsigned char* __restrict__ real, const int* __restrict__ dist,
    const int* __restrict__ tail_of, int (&c)[ITEMS], long long& sum,
    int& heads) {
  unsigned char kb[ITEMS];
  const unsigned char* kp = keep + base;
  if (base + ITEMS <= M && ((uintptr_t)kp & 15) == 0) {
    const uint4 v = *reinterpret_cast<const uint4*>(kp);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) kb[i] = (w[i >> 2] >> (8 * (i & 3))) & 0xFF;
  } else {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) kb[i] = base + i < M ? kp[i] : 0;
  }
  sum = 0;
  heads = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    c[i] = kb[i] ? count_at((int)(base + i), real, dist, tail_of, M) : 0;
    sum += c[i];
    heads += c[i] > 0;
  }
}

// Exclusive block scan of the pairs (s, f) over a block of NW warps; the
// block's totals to (ts, tf).  `sh_s`, `sh_f`: NW entries of shared memory.
template <int NW>
__device__ __forceinline__ void block_scan(long long& s, int& f,
                                           long long* sh_s, int* sh_f,
                                           long long& ts, int& tf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long is = s;
  int fi = f;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long us = __shfl_up_sync(0xFFFFFFFFu, is, d);
    const int uf = __shfl_up_sync(0xFFFFFFFFu, fi, d);
    if (lane >= d) {
      is += us;
      fi += uf;
    }
  }
  if (lane == 31) {
    sh_s[warp] = is;
    sh_f[warp] = fi;
  }
  __syncthreads();
  if (warp == 0) {
    long long ws = lane < NW ? sh_s[lane] : 0;
    int wf = lane < NW ? sh_f[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long us = __shfl_up_sync(0xFFFFFFFFu, ws, d);
      const int uf = __shfl_up_sync(0xFFFFFFFFu, wf, d);
      if (lane >= d) {
        ws += us;
        wf += uf;
      }
    }
    if (lane < NW) {  // inclusive over the warps
      sh_s[lane] = ws;
      sh_f[lane] = wf;
    }
  }
  __syncthreads();
  ts = sh_s[NW - 1];
  tf = sh_f[NW - 1];
  const long long ws = warp ? sh_s[warp - 1] : 0;
  const int wf = warp ? sh_f[warp - 1] : 0;
  s = ws + is - s;  // exclusive
  f = wf + fi - f;
  __syncthreads();  // the shared totals may be overwritten after this
}

__global__ void __launch_bounds__(NT)
    k_count(const unsigned char* __restrict__ keep,
            const unsigned char* __restrict__ real,
            const int* __restrict__ dist, const int* __restrict__ tail_of,
            int M, long long* __restrict__ bs, int* __restrict__ bf) {
  __shared__ long long sh_s[WARPS];
  __shared__ int sh_f[WARPS];
  const long long base = (long long)blockIdx.x * TILE + threadIdx.x * ITEMS;
  int c[ITEMS];
  long long s;
  int f;
  thread_counts(base, M, keep, real, dist, tail_of, c, s, f);
  long long ts;
  int tf;
  block_scan<WARPS>(s, f, sh_s, sh_f, ts, tf);
  if (threadIdx.x == 0) {
    bs[blockIdx.x] = ts;
    bf[blockIdx.x] = tf;
  }
}

// One block: the tiles' pairs scanned in place (exclusive), in chunks of
// CARRY_NT; the totals (members, paths) to tot[0], tot[1].
__global__ void __launch_bounds__(CARRY_NT)
    k_carry(int B, long long* __restrict__ bs, int* __restrict__ bf,
            long long* __restrict__ tot) {
  __shared__ long long sh_s[CARRY_WARPS];
  __shared__ int sh_f[CARRY_WARPS];
  long long carry_s = 0;
  long long carry_f = 0;
  for (int at = 0; at < B; at += CARRY_NT) {
    const int j = at + threadIdx.x;
    long long s = j < B ? bs[j] : 0;
    int f = j < B ? bf[j] : 0;
    long long ts;
    int tf;
    block_scan<CARRY_WARPS>(s, f, sh_s, sh_f, ts, tf);
    if (j < B) {
      bs[j] = carry_s + s;
      bf[j] = (int)(carry_f + f);
    }
    carry_s += ts;
    carry_f += tf;
  }
  if (threadIdx.x == 0) {
    tot[0] = carry_s;
    tot[1] = carry_f;
  }
}

__global__ void __launch_bounds__(NT)
    k_offsets(const unsigned char* __restrict__ keep,
              const unsigned char* __restrict__ real,
              const int* __restrict__ dist, const int* __restrict__ tail_of,
              int M, const long long* __restrict__ bs,
              const int* __restrict__ bf, int* __restrict__ off,
              int* __restrict__ starts, int* __restrict__ head_idx) {
  __shared__ long long sh_s[WARPS];
  __shared__ int sh_f[WARPS];
  const long long base = (long long)blockIdx.x * TILE + threadIdx.x * ITEMS;
  int c[ITEMS];
  long long s;
  int f;
  thread_counts(base, M, keep, real, dist, tail_of, c, s, f);
  long long ts;
  int tf;
  block_scan<WARPS>(s, f, sh_s, sh_f, ts, tf);
  long long o = bs[blockIdx.x] + s;
  int pid = bf[blockIdx.x] + f;
  int w[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    w[i] = -1;
    if (c[i] > 0) {
      w[i] = (int)o;
      starts[pid] = (int)o;
      head_idx[pid] = (int)(base + i);
      ++pid;
      o += c[i];
    }
  }
  int* op = off + base;
  if (base + ITEMS <= M && ((uintptr_t)op & 15) == 0) {
#pragma unroll
    for (int q = 0; q < ITEMS / 4; ++q)
      reinterpret_cast<int4*>(op)[q] =
          make_int4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i)
      if (base + i < M) op[i] = w[i];
  }
}

__global__ void __launch_bounds__(NT)
    k_place(const unsigned char* __restrict__ keep,
            const unsigned char* __restrict__ real,
            const int* __restrict__ head, const int* __restrict__ dist,
            const int* __restrict__ off, const u64* __restrict__ hi,
            const u64* __restrict__ lo, const u64* __restrict__ rhi,
            const u64* __restrict__ rlo,
            const int* __restrict__ node_counts, int M, int k,
            long long M_mem, int* __restrict__ ai, u64* __restrict__ ohi,
            u64* __restrict__ olo, unsigned char* __restrict__ lastb,
            int* __restrict__ counts, int* __restrict__ counters) {
  const long long i = gid();
  bool placed = false, bad = false;
  if (i < M) {
    const int a = (int)i;
    const int h = head[a];
    if ((unsigned)h >= (unsigned)M) {
      bad = true;  // only a malformed forest
    } else {
      const int o = off[h];
      const bool r = real[a >> 1] != 0;
      if (o >= 0) {
        const int d = dist[a];
        const long long pos = (long long)o + d;
        if (!r || d < 0 || pos >= M_mem) {
          bad = true;  // a padding row, or a place past the members
        } else {
          const int n = a >> 1;
          const bool odd = a & 1;
          const u64 wh = odd ? rhi[n] : hi[n], wl = odd ? rlo[n] : lo[n];
          const int kb = 2 * k;  // kmerpack_np.last_base
          ai[pos] = a;
          ohi[pos] = wh;
          olo[pos] = wl;
          lastb[pos] = (unsigned char)(
              (kb <= 64 ? wh >> (64 - kb) : wl >> (128 - kb)) & 3);
          counts[pos] = node_counts[n];
          placed = true;
        }
      } else if (r && keep[h]) {
        bad = true;  // a real node on a padding row's kept path
      }
    }
  }
  const int np = __syncthreads_count(placed);
  const int nb = __syncthreads_count(bad);
  if (threadIdx.x == 0) {
    if (np) atomicAdd(&counters[0], np);
    if (nb) atomicAdd(&counters[1], nb);
  }
}

unsigned blocks(long long n, int per) { return (unsigned)((n + per - 1) / per); }

}  // namespace

extern "C" {

// Tiles of a forest of M oriented nodes: entries of each tile-sum array.
int members_tiles(int M) { return (int)blocks(M, TILE); }

// Launch steps 1-2 on `stream`: keep (bytes, 0 or 1) and tail_of int32[M]
// from K9, dist int32[M], real (bytes) [M / 2] -> tot int64[2] (members,
// paths); bs int64 and bf int32 [members_tiles(M)] of scratch, which step 3
// reads.  Returns the CUDA error of the first call that failed (0 = none).
int members_count_launch(const void* keep, const void* real, const void* dist,
                         const void* tail_of, int M, void* bs, void* bf,
                         void* tot, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(tot, 0, 2 * sizeof(long long), st);
  if (e != cudaSuccess || M <= 0) return (int)e;
  int B = members_tiles(M);
  {
    void* args[] = {&keep, &real, &dist, &tail_of, &M, &bs, &bf};
    e = cudaLaunchKernel(k_count, dim3(B), dim3(NT), args, 0, st);
    if (e != cudaSuccess) return (int)e;
  }
  void* args[] = {&B, &bs, &bf, &tot};
  return (int)cudaLaunchKernel(k_carry, dim3(1), dim3(CARRY_NT), args, 0, st);
}

// Launch steps 3-4 on `stream`, with M_mem and the paths' count read from
// step 2's totals: off int32[M] of scratch; starts, head_idx int32[paths];
// ai, counts int32, ohi, olo u64 and lastb bytes [M_mem]; hi, lo, rhi, rlo
// u64 and node_counts int32 [M / 2]; head int32[M]; 1 <= k <= 63;
// counters int32[2] <- (members placed, members refused).
int members_place_launch(const void* keep, const void* real, const void* head,
                         const void* dist, const void* tail_of, int M,
                         const void* bs, const void* bf, void* off,
                         void* starts, void* head_idx, const void* hi,
                         const void* lo, const void* rhi, const void* rlo,
                         const void* node_counts, int k, long long M_mem,
                         void* ai, void* ohi, void* olo, void* lastb,
                         void* counts, void* counters, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (k < 1 || k > 63) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(counters, 0, 2 * sizeof(int), st);
  if (e != cudaSuccess || M <= 0) return (int)e;
  {
    void* args[] = {&keep, &real, &dist, &tail_of, &M,       &bs,
                    &bf,   &off,  &starts, &head_idx};
    e = cudaLaunchKernel(k_offsets, dim3(members_tiles(M)), dim3(NT), args, 0,
                         st);
    if (e != cudaSuccess) return (int)e;
  }
  void* args[] = {&keep, &real,        &head, &dist, &off, &hi,
                  &lo,   &rhi,         &rlo,  &node_counts, &M, &k,
                  &M_mem, &ai,         &ohi,  &olo,  &lastb, &counts,
                  &counters};
  return (int)cudaLaunchKernel(k_place, dim3(blocks(M, NT)), dim3(NT), args,
                               0, st);
}

}  // extern "C"
