// Ascending unsigned sort of independent windows of W u32 values
// (kernel K4).
//
// Replaces the TPU kernel profile_blocksort.py:63 block_sort (kernel
// make_sort_kernel :49-60, network _bitonic_sort1 :26-46): x[N] is cut into
// G = N / W windows, W a power of two; each window is sorted on its own
// and the windows are not merged.  Keys carry no payload, so the result is
// unique.
//
// What bounds it on an H100: operations on chip, not bytes.  The function
// must read N words and write N words (2 * 4 * N bytes; 1 GiB at N = 2^27,
// 0.32 ms at 3.35 TB/s), but a window's bitonic network has
// log2(W) (log2(W) + 1) / 2 stages of W / 2 compare-exchanges (153 stages
// at W = 2^17: 10^10 compare-exchanges, each an integer minimum and a
// maximum, for 2^27 values), and integer operations issue at half the
// float rate, so the arithmetic alone takes several times the byte bound.
// The design keeps everything else out of the way: the data crosses
// device memory once, shared memory once for every five stages, and a
// compare-exchange is two instructions.
//   * A window lives on chip.  A block of 1024 threads holds 2^15 words in
//     shared memory (a pad word after every 32, so that every access
//     pattern below is free of bank conflicts); a thread block cluster of
//     two or four blocks holds a window of 2^16 or 2^17 words in
//     distributed shared memory.  Smaller windows share a block.
//   * Five stages for one round trip.  A thread takes the 32 words whose
//     window offsets differ in five adjacent bits (bits 0-4, 5-9 or 10-14)
//     into registers, runs every stage whose stride is one of those bits
//     as compare-exchanges between its own registers, and puts them back;
//     the next phase picks another five bits.  A window of 2^17 takes 32
//     such phases for its 153 stages.
//   * Barriers only where words change warps.  In the phases on bits 0-4
//     and 5-9 a warp holds the same 1024 words, so a warp barrier
//     separates them and the warps drift apart, one's shared-memory
//     traffic under another's arithmetic; only a phase on bits 10-14 needs
//     the block's barrier (2.9 ms against 3.3 ms with a block barrier
//     after every phase, N = 2^27, W = 2^17, H100 80GB HBM3 at 700 W).
//   * Only the strides 2^15 and 2^16 cross blocks (three stages of 153):
//     there a thread reads the words at one offset from every block of the
//     cluster, exchanges them and writes them back, between two cluster
//     barriers.
//   * No direction tests.  Merge size k sorts an element ascending where
//     bit k of its window offset is clear.  Instead of steering every
//     compare, the values at offsets with the bit set are kept
//     complemented while that merge runs (complement reverses unsigned
//     order), so every compare-exchange is a plain minimum and maximum;
//     the complement changes once per merge, in registers.
//   * Windows above 2^17 words: the 2^17-word units are sorted as above in
//     the direction their place in the window asks for, and every larger
//     merge size runs its strides of 2^17 and more as coalesced
//     compare-exchange passes over device memory (two strides a pass
//     where both are that large) and finishes in the cluster kernel, which
//     then runs the last merge only.
// At W <= 2^17 that is one kernel and one pass over device memory.
//
// Plain C interface for ctypes; launches on the caller's stream, allocates
// nothing (the wrapper hands in the output) and returns the first CUDA
// error of its launches, or cudaGetLastError().

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 1024;            // threads of a block
constexpr int R = 32;               // words a thread holds in registers
constexpr int LM = 15;              // log2 of the words a block holds
constexpr int M = 1 << LM;
constexpr int SMEM_BYTES = (M + (M >> 5)) * 4;
constexpr int LU = 17;              // log2 of the words a cluster holds
constexpr int GT = 256;             // threads of a device-memory pass block
static_assert(NT * R == M, "a phase holds the whole block in registers");

// Where word l of a block lies in shared memory: a pad word every 32.
__device__ __forceinline__ int phys(int l) { return l + (l >> 5); }

// What one launch of k_sort runs of a window's network.
struct Net {
  int log2w;   // log2 of the window
  int mtop;    // the largest merge (log2 of its size) the cluster can hold
  int mfirst;  // the first merge to run: 1 sorts, mtop runs the last only
  int kbit;    // the bit of the window offset that directs merge mtop
};

// All ones where merge m sorts the element at window offset e descending.
__device__ __forceinline__ uint32_t dmask(unsigned e, int m, const Net& net) {
  if (m > net.mtop) return 0u;
  const int pos = m < net.mtop ? m : net.kbit;
  return (pos < net.log2w && ((e >> pos) & 1u)) ? 0xFFFFFFFFu : 0u;
}

__device__ __forceinline__ void cx(uint32_t& a, uint32_t& b) {
  const uint32_t lo = min(a, b), hi = max(a, b);
  a = lo;
  b = hi;
}

// The stage of stride 2^(P + B) on the 32 words a thread holds.
template <int B>
__device__ __forceinline__ void stage(uint32_t (&v)[R]) {
#pragma unroll
  for (int q = 0; q < R; ++q)
    if (!(q & (1 << B))) cx(v[q], v[q | (1 << B)]);
}

// Word q of the thread's 32 in a phase on bits P .. P + 4, relative to its
// word 0.
template <int P>
__device__ __forceinline__ constexpr int qoff(int q) {
  return (q << P) + ((q << P) >> 5);
}

// A warp's threads hold the same 1024 words in a phase on bits 0-4 and in
// one on bits 5-9, so between those two a warp barrier is enough and the
// warps drift apart, one's shared-memory traffic under another's
// arithmetic; a phase on bits 10-14 trades words between warps and needs
// the block's barrier before and after.
__device__ __forceinline__ void barrier(bool block) {
  if (block) __syncthreads(); else __syncwarp();
}

// One phase: after the barrier that makes the phase before it visible,
// the stages of strides 2^(P + top) .. 2^P in registers, then every value
// XORed with flip.
template <int P>
__device__ __forceinline__ void phase(uint32_t* s, int tid, int top,
                                      uint32_t flip, bool after_block) {
  const int pb = phys(((tid >> P) << (P + 5)) | (tid & ((1 << P) - 1)));
  uint32_t v[R];
  barrier(after_block);
#pragma unroll
  for (int q = 0; q < R; ++q) v[q] = s[pb + qoff<P>(q)];
  if (top >= 4) stage<4>(v);
  if (top >= 3) stage<3>(v);
  if (top >= 2) stage<2>(v);
  if (top >= 1) stage<1>(v);
  stage<0>(v);
#pragma unroll
  for (int q = 0; q < R; ++q) s[pb + qoff<P>(q)] = v[q] ^ flip;
}

// Bit m of the window offset of word q of thread-block word base 32 * eh.
template <int MB>
__device__ __forceinline__ uint32_t obit(int q, unsigned eh) {
  if constexpr (MB < 5) {
    return (uint32_t)((q >> MB) & 1);
  } else {
    return (eh >> (MB - 5)) & 1u;
  }
}

// Merge m of the first phase, all in registers, and the change of the
// complement from merge m to merge m + 1.
template <int MB>
__device__ __forceinline__ void small_merge(uint32_t (&v)[R], unsigned eh) {
  if (MB >= 5) stage<4>(v);
  if (MB >= 4) stage<3>(v);
  if (MB >= 3) stage<2>(v);
  if (MB >= 2) stage<1>(v);
  stage<0>(v);
#pragma unroll
  for (int q = 0; q < R; ++q)
    v[q] ^= 0u - (obit<MB>(q, eh) ^ obit<MB + 1>(q, eh));
}

// The first phase: merges 1 to 5 (every window has at least 2^7 words, so
// their directions are plain bits of the offset).
__device__ __forceinline__ void first_phase(uint32_t* s, int tid,
                                            unsigned eh) {
  const int pb = phys(tid << 5);
  uint32_t v[R];
  __syncwarp();
#pragma unroll
  for (int q = 0; q < R; ++q) v[q] = s[pb + q] ^ (0u - obit<1>(q, eh));
  small_merge<1>(v, eh);
  small_merge<2>(v, eh);
  small_merge<3>(v, eh);
  small_merge<4>(v, eh);
  small_merge<5>(v, eh);
#pragma unroll
  for (int q = 0; q < R; ++q) s[pb + q] = v[q];
}

// The strides 2^(m - 1) .. 2^LM of merge m, which pair words of different
// blocks: a thread takes the words at one offset from every block.
template <int CS>
__device__ __forceinline__ void cross(uint32_t* s, int tid, int m) {
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  uint32_t* rs[CS];
#pragma unroll
  for (int c = 0; c < CS; ++c) rs[c] = cl.map_shared_rank(s, c);
  constexpr int PER = M / CS;
  const int first = (int)cl.block_rank() * PER;
#pragma unroll 4
  for (int x = tid; x < PER; x += NT) {
    const int p = phys(first + x);
    uint32_t v[CS];
#pragma unroll
    for (int c = 0; c < CS; ++c) v[c] = rs[c][p];
    if constexpr (CS == 4) {
      if (m == LM + 2) {
        cx(v[0], v[2]);
        cx(v[1], v[3]);
      }
      cx(v[0], v[1]);
      cx(v[2], v[3]);
    } else {
      cx(v[0], v[1]);
    }
#pragma unroll
    for (int c = 0; c < CS; ++c) rs[c][p] = v[c];
  }
  cl.sync();
}

// A cluster of CS blocks holds CS * 2^15 consecutive words: one window or
// part of one (CS > 1), or one or several windows (CS == 1).
template <int CS>
__global__ void __launch_bounds__(NT, 1) k_sort(const uint32_t* in,
                                                uint32_t* out, long long N,
                                                Net net, unsigned wmask) {
  extern __shared__ uint32_t s[];
  const int tid = threadIdx.x;
  const long long base = (long long)blockIdx.x * M;
  const unsigned wofs = (unsigned)base & wmask;  // 0 where W <= 2^15
  // when only the last merge runs, its direction is the cluster's
  const uint32_t flip0 = net.mfirst > 1 ? dmask(wofs, net.mfirst, net) : 0u;
  // a warp loads and stores the 1024 words its first and last phases hold
  const int l0 = ((tid >> 5) << 10) | (tid & 31);
#pragma unroll 8
  for (int l = l0; l < l0 + 1024; l += 32) {
    const long long i = base + l;
    s[phys(l)] = (i < N ? in[i] : 0xFFFFFFFFu) ^ flip0;
  }

  // window offset of the thread's words in a phase on bits 0-4, bits 5 up
  const unsigned e = (wofs | ((unsigned)tid << 5)) & wmask;
  if (net.mfirst == 1) {
    first_phase(s, tid, e >> 5);
    const int mlocal = net.mtop < LM ? net.mtop : LM;
    for (int m = 6; m <= mlocal; ++m) {
      if (m > 10) phase<10>(s, tid, m - 11, 0u, true);
      phase<5>(s, tid, m > 10 ? 4 : m - 6, 0u, m > 10);
      phase<0>(s, tid, 4, dmask(e, m, net) ^ dmask(e, m + 1, net), false);
    }
  }
  if constexpr (CS > 1) {
    for (int m = net.mfirst > LM + 1 ? net.mfirst : LM + 1; m <= net.mtop;
         ++m) {
      cross<CS>(s, tid, m);  // begins and ends with the cluster's barrier
      phase<10>(s, tid, 4, 0u, false);
      phase<5>(s, tid, 4, 0u, true);
      phase<0>(s, tid, 4, dmask(e, m, net) ^ dmask(e, m + 1, net), false);
    }
  }
  __syncwarp();
#pragma unroll 8
  for (int l = l0; l < l0 + 1024; l += 32) {
    const long long i = base + l;
    if (i < N) out[i] = s[phys(l)];
  }
}

__device__ __forceinline__ void cxd(uint32_t& a, uint32_t& b, bool asc) {
  if ((a > b) == asc) {
    uint32_t t = a;
    a = b;
    b = t;
  }
}

__device__ __forceinline__ void cxd4(uint4& a, uint4& b, bool asc) {
  cxd(a.x, b.x, asc);
  cxd(a.y, b.y, asc);
  cxd(a.z, b.z, asc);
  cxd(a.w, b.w, asc);
}

// One stride j >= 2^LU of merge size k over device memory: thread t owns
// the four words at i and the four at i + j, where i is 4 t with a zero
// bit inserted at j's place.  All eight share one direction (k > j >= 4).
__global__ void __launch_bounds__(GT) k_global_step1(uint32_t* __restrict__ x,
                                                     long long nquads,
                                                     long long j, unsigned k,
                                                     unsigned wmask) {
  long long t = (long long)blockIdx.x * GT + threadIdx.x;
  if (t >= nquads) return;
  long long e = t << 2;
  long long i = ((e & ~(j - 1)) << 1) | (e & (j - 1));
  bool asc = (((unsigned)(i & wmask)) & k) == 0;
  uint4* pa = reinterpret_cast<uint4*>(x + i);
  uint4* pb = reinterpret_cast<uint4*>(x + i + j);
  uint4 a = *pa, b = *pb;
  cxd4(a, b, asc);
  *pa = a;
  *pb = b;
}

// Two strides, j and j / 2 (both >= 2^LU), of merge size k in one pass:
// thread t owns four words at each of i, i + j/2, i + j, i + 3j/2, where i
// is 4 t with two zero bits inserted at the places of j/2 and j.
__global__ void __launch_bounds__(GT) k_global_step2(uint32_t* __restrict__ x,
                                                     long long nquads,
                                                     long long j, unsigned k,
                                                     unsigned wmask) {
  long long t = (long long)blockIdx.x * GT + threadIdx.x;
  if (t >= nquads) return;
  long long h = j >> 1;
  long long e = t << 2;
  long long i = ((e & ~(h - 1)) << 2) | (e & (h - 1));
  bool asc = (((unsigned)(i & wmask)) & k) == 0;
  uint4* p0 = reinterpret_cast<uint4*>(x + i);
  uint4* p1 = reinterpret_cast<uint4*>(x + i + h);
  uint4* p2 = reinterpret_cast<uint4*>(x + i + j);
  uint4* p3 = reinterpret_cast<uint4*>(x + i + j + h);
  uint4 a = *p0, b = *p1, c = *p2, d = *p3;
  cxd4(a, c, asc);  // stride j
  cxd4(b, d, asc);
  cxd4(a, b, asc);  // stride j / 2
  cxd4(c, d, asc);
  *p0 = a;
  *p1 = b;
  *p2 = c;
  *p3 = d;
}

template <int CS>
cudaError_t launch_sort(const uint32_t* in, uint32_t* out, long long N,
                        Net net, unsigned wmask, cudaStream_t st) {
  // above 48 KB of shared memory has to be asked for, on the current
  // device: done on every launch, the call is cheap
  cudaError_t e = cudaFuncSetAttribute(
      k_sort<CS>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((N + M - 1) / M));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, k_sort<CS>, in, out, N, net, wmask);
}

}  // namespace

extern "C" {

// in, out: N words each (out != in); W a power of two >= 128 that divides
// N.  The wrapper checks the rest of the contract.
int block_sort_launch(const void* in, void* out, long long N, long long W,
                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (N <= 0) return (int)cudaGetLastError();
  if (W < 128 || (W & (W - 1)) || W > (1ll << 30) || N % W) return -1;
  uint32_t* x = (uint32_t*)out;
  const unsigned wmask = (unsigned)W - 1;
  int log2w = 0;
  while ((1ll << log2w) < W) ++log2w;
  Net net;
  net.log2w = log2w;
  net.mtop = log2w < LU ? log2w : LU;
  net.mfirst = 1;
  net.kbit = net.mtop;
  cudaError_t err;
  if (log2w <= LM)
    err = launch_sort<1>((const uint32_t*)in, x, N, net, wmask, st);
  else if (log2w == LM + 1)
    err = launch_sort<2>((const uint32_t*)in, x, N, net, wmask, st);
  else
    err = launch_sort<4>((const uint32_t*)in, x, N, net, wmask, st);
  // windows above the cluster's reach: the large strides of every further
  // merge size over device memory, the rest in the cluster kernel
  const long long U = 1ll << LU;
  net.mfirst = LU;
  for (int kb = LU + 1; kb <= log2w && err == cudaSuccess; ++kb) {
    const long long k = 1ll << kb;
    long long j = k >> 1;
    while (j >= U && err == cudaSuccess) {
      if ((j >> 1) >= U) {
        long long nquads = N >> 4;  // 16 words a thread
        k_global_step2<<<(unsigned)((nquads + GT - 1) / GT), GT, 0, st>>>(
            x, nquads, j, (unsigned)k, wmask);
        j >>= 2;
      } else {
        long long nquads = N >> 3;  // 8 words a thread
        k_global_step1<<<(unsigned)((nquads + GT - 1) / GT), GT, 0, st>>>(
            x, nquads, j, (unsigned)k, wmask);
        j >>= 1;
      }
      err = cudaGetLastError();
    }
    if (err != cudaSuccess) break;
    net.kbit = kb;
    err = launch_sort<4>(x, x, N, net, wmask, st);
  }
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
