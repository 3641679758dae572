// Counts of sorted query keys against the sorted k-mer spectrum (kernel K2).
//
// Replaces the TPU kernel sh_assembly_tpu/ops/join_pallas.py:
// count_join_planes.  The store holds n_main live packed words
//   packed = key << KSHIFT | traveled << CBITS | count
// in ascending unsigned order with distinct keys; the queries are raw keys,
// ascending, with all-ones sentinels at the tail.  Each query gets the count
// field of the live entry with its key (the traveled bit is not part of
// it), or 0 when no live entry has that key; a sentinel query gets 0.
//
// What bounds it on an H100: memory latency, not bytes.  Each query reads
// its own 8 bytes and writes 4, but locating it is a dependent chain of
// loads into a store of up to 2^29 words (4 GiB, far beyond the 50 MB L2).
// Design: one thread per query, a lower-bound binary search on the key
// part with uint64_t arithmetic.  The queries are sorted, so a block's 256
// queries cover one narrow key range: two threads first bound that range
// with full-depth searches, and every thread then searches only inside it
// (a few steps, over lines the block's neighbours also touch).  Blocks are
// independent; there is no cross-block state.
//
// Plain C interface for ctypes; launches on the caller's stream, allocates
// nothing (the wrapper hands in the output) and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;  // queries per block
constexpr uint64_t SENT = ~0ull;

// First index in [lo, hi) whose key is >= q (hi if none).
__device__ __forceinline__ long long lower_bound(const uint64_t* store,
                                                 long long lo, long long hi,
                                                 uint64_t q, int kshift) {
  while (lo < hi) {
    long long mid = lo + ((hi - lo) >> 1);
    if ((store[mid] >> kshift) < q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(NT) k_count_join(
    const uint64_t* __restrict__ store, long long n_main,
    const uint64_t* __restrict__ queries, long long nq,
    int* __restrict__ out, int kshift, uint64_t cmask) {
  __shared__ long long range[2];
  __shared__ uint64_t qlast;
  long long b0 = (long long)blockIdx.x * NT;
  long long i = b0 + threadIdx.x;
  long long nblk = nq - b0 < NT ? nq - b0 : NT;
  uint64_t q = i < nq ? queries[i] : SENT;
  // the block's largest real query: the one before its first sentinel
  if (threadIdx.x == 0) qlast = SENT;
  __syncthreads();
  if (q != SENT && (threadIdx.x + 1 == nblk || queries[i + 1] == SENT))
    qlast = q;
  __syncthreads();
  if (threadIdx.x == 0)
    range[0] = queries[b0] == SENT
                   ? n_main
                   : lower_bound(store, 0, n_main, queries[b0], kshift);
  if (threadIdx.x == 1)
    range[1] = qlast == SENT
                   ? n_main
                   : lower_bound(store, 0, n_main, qlast + 1, kshift);
  __syncthreads();
  if (i >= nq) return;
  int c = 0;
  if (q != SENT) {
    long long p = lower_bound(store, range[0], range[1], q, kshift);
    if (p < range[1]) {
      uint64_t e = store[p];
      if ((e >> kshift) == q) c = (int)(e & cmask);
    }
  }
  out[i] = c;
}

}  // namespace

extern "C" {

int count_join_launch(const void* store, long long n_main,
                      const void* queries, long long nq, void* out,
                      int key_bits, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int kshift = 64 - key_bits;
  int cbits = (kshift < 32 ? kshift : 32) - 1;
  uint64_t cmask = (1ull << cbits) - 1;
  if (nq > 0) {
    long long blocks = (nq + NT - 1) / NT;
    k_count_join<<<(unsigned)blocks, NT, 0, st>>>(
        (const uint64_t*)store, n_main, (const uint64_t*)queries, nq,
        (int*)out, kshift, cmask);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
