// Ascending unsigned sort of independent windows of W u32 values
// (kernel K4).
//
// Replaces the TPU kernel profile_blocksort.py:63 block_sort (kernel
// make_sort_kernel :49-60, network _bitonic_sort1 :26-46): x[N] is cut into
// G = N / W windows, W a power of two; each window is sorted on its own
// and the windows are not merged.  Keys carry no payload, so the result is
// unique.
//
// What bounds it on an H100: bytes.  The function must read N words and
// write N words (2 * 4 * N bytes; 1 GiB at N = 2^27, 0.32 ms at
// 3.35 TB/s).  The TPU kernel holds a whole 2^17-word window (512 KiB) in
// VMEM and runs all 153 compare-exchange stages there; a block on this
// card has 227 KB of shared memory, so a window cannot live in one block.
// Design, a bitonic network split by stride:
//   * k_sort_chunks: a block sorts one chunk of CH = 2^13 words (32 KB,
//     two blocks of 1024 threads per SM) in shared memory; the direction
//     of a compare follows the element's place in its WINDOW, so a chunk
//     comes out ascending or descending as the window's network needs it.
//     When W < CH a chunk holds CH / W whole windows and the network stops
//     at merge size W.
//   * for every merge size k = 2 CH .. W: the strides j >= CH run as
//     coalesced compare-exchange passes over device memory (16 B per
//     thread and side; two strides per pass where both are >= CH, so the
//     four words a thread holds are exchanged twice in registers), and the
//     strides below CH finish in one shared-memory pass (k_merge_chunks).
// At W = 2^17 that is 1 + 6 + 4 = 11 passes over the data against the
// bound's one, all in place on the output after the first.
//
// Plain C interface for ctypes; launches on the caller's stream, allocates
// nothing (the wrapper hands in the output) and returns the first CUDA
// error of its launches, or cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int CH = 1 << 13;  // words a block sorts in shared memory
constexpr int NT = 1024;     // threads of a shared-memory block
constexpr int GT = 256;      // threads of a device-memory pass block

// One compare-exchange stage of stride j inside merge size k over the n
// words of s (pairs never leave a window).  wofs is the offset of s[0] in
// its window and wmask = W - 1: element e of a window sorts ascending
// where (e & k) == 0.
__device__ __forceinline__ void stage(uint32_t* s, int n, int j, unsigned k,
                                      unsigned wofs, unsigned wmask) {
  for (int t = threadIdx.x; t < (n >> 1); t += NT) {
    int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
    int p = i | j;
    bool asc = (((wofs + (unsigned)i) & wmask) & k) == 0;
    uint32_t a = s[i], b = s[p];
    if ((a > b) == asc) {
      s[i] = b;
      s[p] = a;
    }
  }
  __syncthreads();
}

// Full bitonic sort of each chunk up to merge size min(W, CH).
__global__ void __launch_bounds__(NT) k_sort_chunks(
    const uint32_t* __restrict__ in, uint32_t* __restrict__ out, long long N,
    unsigned W) {
  __shared__ uint32_t s[CH];
  long long base = (long long)blockIdx.x * CH;
  int n = N - base < CH ? (int)(N - base) : CH;  // a multiple of min(W, CH)
  for (int t = threadIdx.x; t < n; t += NT) s[t] = in[base + t];
  __syncthreads();
  unsigned wmask = W - 1;
  unsigned wofs = (unsigned)(base & wmask);
  unsigned kmax = W < (unsigned)CH ? W : (unsigned)CH;
  for (unsigned k = 2; k <= kmax; k <<= 1)
    for (int j = (int)(k >> 1); j >= 1; j >>= 1) stage(s, n, j, k, wofs, wmask);
  for (int t = threadIdx.x; t < n; t += NT) out[base + t] = s[t];
}

// The strides CH/2 .. 1 of merge size k (k > CH, so W > CH and every
// chunk is whole).
__global__ void __launch_bounds__(NT) k_merge_chunks(uint32_t* __restrict__ x,
                                                     unsigned W, unsigned k) {
  __shared__ uint32_t s[CH];
  long long base = (long long)blockIdx.x * CH;
  for (int t = threadIdx.x; t < CH; t += NT) s[t] = x[base + t];
  __syncthreads();
  unsigned wmask = W - 1;
  unsigned wofs = (unsigned)(base & wmask);
  for (int j = CH >> 1; j >= 1; j >>= 1) stage(s, CH, j, k, wofs, wmask);
  for (int t = threadIdx.x; t < CH; t += NT) x[base + t] = s[t];
}

__device__ __forceinline__ void cx(uint32_t& a, uint32_t& b, bool asc) {
  if ((a > b) == asc) {
    uint32_t t = a;
    a = b;
    b = t;
  }
}

__device__ __forceinline__ void cx4(uint4& a, uint4& b, bool asc) {
  cx(a.x, b.x, asc);
  cx(a.y, b.y, asc);
  cx(a.z, b.z, asc);
  cx(a.w, b.w, asc);
}

// One stride j >= CH of merge size k over device memory: thread t owns
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
  cx4(a, b, asc);
  *pa = a;
  *pb = b;
}

// Two strides, j and j / 2 (both >= CH), of merge size k in one pass:
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
  cx4(a, c, asc);  // stride j
  cx4(b, d, asc);
  cx4(a, b, asc);  // stride j / 2
  cx4(c, d, asc);
  *p0 = a;
  *p1 = b;
  *p2 = c;
  *p3 = d;
}

}  // namespace

extern "C" {

// in, out: N words each (out != in); W a power of two >= 2 that divides N.
// The wrapper checks the rest of the contract.
int block_sort_launch(const void* in, void* out, long long N, long long W,
                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (N <= 0) return (int)cudaGetLastError();
  if (W < 2 || (W & (W - 1)) || W > (1ll << 30) || N % W) return -1;
  uint32_t* x = (uint32_t*)out;
  unsigned w = (unsigned)W, wmask = w - 1;
  long long chunks = (N + CH - 1) / CH;
  k_sort_chunks<<<(unsigned)chunks, NT, 0, st>>>((const uint32_t*)in, x, N, w);
  cudaError_t err = cudaGetLastError();
  for (long long k = 2ll * CH; k <= W && err == cudaSuccess; k <<= 1) {
    long long j = k >> 1;
    while (j >= CH && err == cudaSuccess) {
      if ((j >> 1) >= CH) {
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
    k_merge_chunks<<<(unsigned)chunks, NT, 0, st>>>(x, w, (unsigned)k);
    err = cudaGetLastError();
  }
  return (int)err;
}

}  // extern "C"
