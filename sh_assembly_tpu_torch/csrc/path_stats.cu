// Per-path statistics of the kept paths (kernel K11): each path's median
// count, the sum of its counts and its seed flag, from K10's
// member-ordered arrays where they lie.
//
// Replaces no Pallas kernel: in the JAX package these are numpy lines of
// the host assembly (_finalize_host, sh_assembly_tpu/models/contiger.py,
// "per-path medians" and "solid seed flag per path"): one np.lexsort of
// every member by (path, count), the median read at each path's middle,
// np.add.reduceat for the sums and for the seed flags.  The results are
// theirs, bit for bit:
//   med[p]    the middle count of path p's sorted counts where its length
//             L is odd; (a + b) // 2 of the two middle ones where it is
//             even (floor division, in 64 bits)
//   sum[p]    the 64-bit sum of its counts (the host forms the mean as
//             float64(sum) / L, which is what reduceat's sum gives)
//   flag[p]   1 where some member's count lies in [smin, smax] and, with a
//             seed mask, its node's seed byte (seed[ai >> 1]) is set.
//
// Why no sort: K10 leaves a path's members contiguous, starting at
// starts[p] and ending where the next path starts (the last at M_mem), so
// a median is a selection within one segment, and a global sort of every
// member by (path, count) is work no answer needs.
//
// How:
//   1. k_short    a warp a path (WARPS_A paths a block).  A path of at most
//                 32 members holds one count a lane: each lane ranks its
//                 count against the others by 32 shuffles (ties broken by
//                 lane), and the lanes of ranks L / 2 - 1 and L / 2 give
//                 the median; the sum is a warp reduction, the flag a
//                 ballot.  A longer path is appended to a list (one atomic
//                 a path) for step 2.
//   2. k_long     persistent blocks of NT_B threads take the listed paths
//                 one at a time (an atomic cursor, so a long path does not
//                 hold up a block's others).  A first pass reads the counts
//                 once: sum, flag, the least and the largest key (counts
//                 with their sign bit flipped, so unsigned order is integer
//                 order), and, for a path of at most STAGE members (the
//                 in-block limit), the keys into shared memory.  The
//                 selection is a radix select over only the bits where the
//                 least and the largest key differ, 8 bits a pass: a
//                 histogram of the candidates' digit in shared memory
//                 (warp-aggregated atomics: counts repeat), and warp 0
//                 scans it to find the digit that holds the wanted rank.
//                 At 30x the counts of a path differ in their low 6-8
//                 bits, so one pass selects.  An even length selects rank
//                 L / 2 - 1, and a last pass counts the keys at or below it
//                 and finds the least key above it, which gives rank L / 2.
//                 Longer paths read their counts from device memory (L2)
//                 in each pass.
// The lengths it is shaped for (one job of each 30x pipeline cell on an
// H100): two thirds of the kept paths hold at most 32 members, more than
// half of them one, and hold 2-3 % of the members; the rest are at most
// 2-4 thousand long, under STAGE.  So k_short takes most paths and k_long
// most members, each from shared memory after one read.
// What bounds it on an H100: the bytes read, once each in the short
// paths: the counts and the oriented indices (8 B a member), each
// member's seed byte (a random byte of the node mask; without a mask,
// none), each path's start; 17 B written a path.  The long paths read
// their counts once more a pass, from shared memory or L2.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int WARP_MAX = 32;           // paths up to this long: a warp each
constexpr int WARPS_A = 8;             // k_short: warps (paths) a block
constexpr int NT_B = 256;              // k_long: threads a block
constexpr int WARPS_B = NT_B / 32;
constexpr int STAGE = 4096;            // k_long: members staged in smem
constexpr int DIGIT = 8;               // bits a radix pass
constexpr int BINS = 1 << DIGIT;
constexpr int BLOCKS_PER_SM = 8;       // k_long's persistent blocks

__device__ __forceinline__ unsigned okey(int c) {
  return (unsigned)c ^ 0x80000000u;
}
__device__ __forceinline__ int oval(unsigned key) {
  return (int)(key ^ 0x80000000u);
}

struct Args {
  const int* counts;           // [M_mem]
  const int* starts;           // [P]
  const int* ai;               // [M_mem]
  const unsigned char* seed;   // [nodes] or null
  long long smin, smax;
  int M_mem, P;
  long long* med;              // [P]
  long long* sum;              // [P]
  unsigned char* flag;         // [P]
  int* long_list;              // [P] scratch
  int* ctr;                    // [2]: listed paths, k_long's cursor
};

__device__ __forceinline__ bool seeds(const Args& a, int c, int i) {
  return c >= a.smin && c <= a.smax && (!a.seed || a.seed[a.ai[i] >> 1]);
}

__device__ __forceinline__ int path_end(const Args& a, int p) {
  return p + 1 < a.P ? a.starts[p + 1] : a.M_mem;
}

__global__ void __launch_bounds__(WARPS_A * 32) k_short(Args a) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * WARPS_A + (threadIdx.x >> 5);
  if (p >= a.P) return;  // the whole warp
  const int s = a.starts[p];
  const int L = path_end(a, p) - s;
  if (L > WARP_MAX) {
    if (lane == 0) a.long_list[atomicAdd(&a.ctr[0], 1)] = p;
    return;
  }
  const bool in = lane < L;
  const int c = in ? a.counts[s + lane] : 0;
  const unsigned key = in ? okey(c) : FULL;
  const unsigned any = __ballot_sync(FULL, in && seeds(a, c, s + lane));
  long long t = c;
#pragma unroll
  for (int d = 16; d; d >>= 1) t += __shfl_xor_sync(FULL, t, d);
  // rank among the path's counts, ties by lane; lanes past L hold the
  // largest key and come after every real one
  int rank = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const unsigned kj = __shfl_sync(FULL, key, j);
    rank += (kj < key) | ((kj == key) & (j < lane));
  }
  const int mid = L >> 1;
  const unsigned ba =
      __ballot_sync(FULL, in && rank == ((L & 1) ? mid : mid - 1));
  const unsigned bb = __ballot_sync(FULL, in && rank == mid);
  const int va = __shfl_sync(FULL, c, __ffs(ba) - 1);
  const int vb = __shfl_sync(FULL, c, __ffs(bb) - 1);
  if (lane == 0) {
    a.med[p] = (L & 1) ? (long long)vb : ((long long)va + vb) >> 1;
    a.sum[p] = t;
    a.flag[p] = any != 0;
  }
}

// Block reductions of k_long (every thread gets the result).
struct Shared {
  unsigned keys[STAGE];
  int hist[BINS];
  long long red_s[WARPS_B];
  unsigned red_a[WARPS_B], red_b[WARPS_B];
  int red_c[WARPS_B];
  int job, digit, rest;
};

__device__ __forceinline__ long long block_sum(long long v, Shared& sh) {
#pragma unroll
  for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
  if ((threadIdx.x & 31) == 0) sh.red_s[threadIdx.x >> 5] = v;
  __syncthreads();
  long long t = 0;
#pragma unroll
  for (int w = 0; w < WARPS_B; ++w) t += sh.red_s[w];
  __syncthreads();
  return t;
}

__device__ __forceinline__ int block_count(int v, Shared& sh) {
#pragma unroll
  for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
  if ((threadIdx.x & 31) == 0) sh.red_c[threadIdx.x >> 5] = v;
  __syncthreads();
  int t = 0;
#pragma unroll
  for (int w = 0; w < WARPS_B; ++w) t += sh.red_c[w];
  __syncthreads();
  return t;
}

// (least of lo, largest of hi) over the block.
__device__ __forceinline__ void block_minmax(unsigned& lo, unsigned& hi,
                                             Shared& sh) {
#pragma unroll
  for (int d = 16; d; d >>= 1) {
    lo = min(lo, __shfl_xor_sync(FULL, lo, d));
    hi = max(hi, __shfl_xor_sync(FULL, hi, d));
  }
  if ((threadIdx.x & 31) == 0) {
    sh.red_a[threadIdx.x >> 5] = lo;
    sh.red_b[threadIdx.x >> 5] = hi;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < WARPS_B; ++w) {
    lo = min(lo, sh.red_a[w]);
    hi = max(hi, sh.red_b[w]);
  }
  __syncthreads();
}

__device__ __forceinline__ unsigned key_at(const Args& a, const Shared& sh,
                                           bool staged, int s, int i) {
  return staged ? sh.keys[i] : okey(a.counts[s + i]);
}

// The key of rank r (0-based) among the path's L keys, all within
// [kmin, kmax] (kmin != kmax).
__device__ unsigned select_rank(const Args& a, Shared& sh, bool staged, int s,
                                int L, int r, unsigned kmin, unsigned kmax) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int nb = 32 - __clz(kmin ^ kmax);  // low bits left to resolve
  u64 prefix = nb == 32 ? 0 : (u64)(kmin >> nb) << nb;
  const int Lpad = (L + NT_B - 1) / NT_B * NT_B;
  while (nb > 0) {
    const int w = nb < DIGIT ? nb : DIGIT;
    const int shift = nb - w;
    for (int b = threadIdx.x; b < BINS; b += NT_B) sh.hist[b] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < Lpad; i += NT_B) {
      int d = -1;
      if (i < L) {
        const u64 key = key_at(a, sh, staged, s, i);
        if ((key >> nb) == (prefix >> nb))
          d = (int)((key >> shift) & ((1u << w) - 1));
      }
      // counts repeat: one atomic a distinct digit of the warp
      const unsigned peers = __match_any_sync(FULL, d);
      if (d >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(&sh.hist[d], __popc(peers));
    }
    __syncthreads();
    if (warp == 0) {
      constexpr int PER = BINS / 32;
      int h[PER], own = 0;
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        h[q] = sh.hist[lane * PER + q];
        own += h[q];
      }
      int incl = own;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl += u;
      }
      int below = incl - own;
      if (below <= r && r < incl) {
#pragma unroll
        for (int q = 0; q < PER; ++q) {
          if (r < below + h[q]) {
            sh.digit = lane * PER + q;
            sh.rest = r - below;
            break;
          }
          below += h[q];
        }
      }
    }
    __syncthreads();
    prefix |= (u64)sh.digit << shift;
    r = sh.rest;
    nb = shift;
    __syncthreads();
  }
  return (unsigned)prefix;
}

__global__ void __launch_bounds__(NT_B) k_long(Args a) {
  __shared__ Shared sh;
  const int n_long = a.ctr[0];
  for (;;) {
    if (threadIdx.x == 0) sh.job = atomicAdd(&a.ctr[1], 1);
    __syncthreads();
    const int j = sh.job;
    if (j >= n_long) return;
    const int p = a.long_list[j];
    const int s = a.starts[p];
    const int L = path_end(a, p) - s;
    const bool staged = L <= STAGE;
    long long t = 0;
    int any = 0;
    unsigned kmin = FULL, kmax = 0;
    for (int i = threadIdx.x; i < L; i += NT_B) {
      const int c = a.counts[s + i];
      const unsigned key = okey(c);
      if (staged) sh.keys[i] = key;
      t += c;
      any |= seeds(a, c, s + i);
      kmin = min(kmin, key);
      kmax = max(kmax, key);
    }
    t = block_sum(t, sh);
    any = __syncthreads_or(any);
    block_minmax(kmin, kmax, sh);
    const int mid = L >> 1;
    long long m;
    if (kmin == kmax) {
      m = oval(kmin);
    } else {
      const unsigned ka = select_rank(a, sh, staged, s, L,
                                      (L & 1) ? mid : mid - 1, kmin, kmax);
      if (L & 1) {
        m = oval(ka);
      } else {
        // rank mid: ka again if more than mid keys lie at or below it,
        // else the least key above it
        int le = 0;
        unsigned above = FULL, unused = 0;
        for (int i = threadIdx.x; i < L; i += NT_B) {
          const unsigned key = key_at(a, sh, staged, s, i);
          le += key <= ka;
          if (key > ka) above = min(above, key);
        }
        le = block_count(le, sh);
        block_minmax(above, unused, sh);
        const unsigned kb = le > mid ? ka : above;
        m = ((long long)oval(ka) + oval(kb)) >> 1;
      }
    }
    if (threadIdx.x == 0) {
      a.med[p] = m;
      a.sum[p] = t;
      a.flag[p] = any != 0;
    }
    __syncthreads();  // sh.keys and sh.job are rewritten for the next path
  }
}

unsigned blocks(long long n, int per) { return (unsigned)((n + per - 1) / per); }

}  // namespace

extern "C" {

// Launch K11 on `stream`: counts, ai int32[M_mem] and starts int32[P] from
// K10 (starts increasing, starts[0] = 0, every path at least one member);
// seed: bytes over the nodes (ai >> 1), or null for no mask; med, sum
// int64 and flag bytes [P]; long_list int32[P] and ctr int32[2] of scratch.
// Returns the CUDA error of the first call that failed (0 = none).
int path_stats_launch(const void* counts, const void* starts, const void* ai,
                      const void* seed, long long smin, long long smax,
                      int M_mem, int P, void* med, void* sum, void* flag,
                      void* long_list, void* ctr, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(ctr, 0, 2 * sizeof(int), st);
  if (e != cudaSuccess || P <= 0) return (int)e;
  Args a{(const int*)counts, (const int*)starts, (const int*)ai,
         (const unsigned char*)seed, smin, smax, M_mem, P,
         (long long*)med, (long long*)sum, (unsigned char*)flag,
         (int*)long_list, (int*)ctr};
  void* args[] = {&a};
  e = cudaLaunchKernel(k_short, dim3(blocks(P, WARPS_A)), dim3(WARPS_A * 32),
                       args, 0, st);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned G = (unsigned)(sms * BLOCKS_PER_SM);
  const unsigned grid = G < blocks(P, 1) ? G : blocks(P, 1);
  return (int)cudaLaunchKernel(k_long, dim3(grid), dim3(NT_B), args, 0, st);
}

// The longest path k_short takes and the longest k_long stages in shared
// memory (its in-block limit).
int path_stats_warp_max() { return WARP_MAX; }
int path_stats_stage() { return STAGE; }

}  // extern "C"
