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
// What bounds it on an H100: bytes, if the store is streamed and not
// searched.  A query reads 8 bytes and writes 4; the callers' probes are
// denser than the store (several queries per live key in the graph probes
// and the phantom closure), so the store words a run of queries needs are
// few and contiguous.  What has to be kept off the critical path is the
// chain of ~27 dependent loads that locates a key in a store far beyond
// the 50 MB L2.
// Design, two kernels:
//   1. k_partition   one thread per tile boundary (a tile is TQ queries):
//                    the full-depth lower bound in the live store of the
//                    tile's first query, for all tiles at once, so the long
//                    searches overlap each other instead of stalling a
//                    block each.
//                    A boundary that falls on the sentinel tail takes the
//                    last real query before it, so the tail does not widen
//                    a tile's range.
//   2. k_join_tiles  one block per tile.  The tile's store range
//                    [lo[t], lo[t+1]] is read once, as asynchronous 16-byte
//                    copies, into shared memory when it fits (SW words),
//                    and every thread answers QPT consecutive queries
//                    there: a binary search for the first, a galloping
//                    search from the previous answer for the rest; queries
//                    are read with 16-byte loads and counts written with
//                    16-byte stores where the addresses allow.  A tile
//                    whose range does not fit (few queries against a wide
//                    store) searches device memory inside its range, one
//                    query after the other, the lanes of a warp on
//                    neighbouring queries so that their loads fall close
//                    together.  (Overlapping a thread's searches made this
//                    path slower on the card: it is bound by the rate of
//                    scattered loads an SM can issue, not by their
//                    latency.)
//                    The choice is per tile, from the partition array.
// Blocks are independent.
//
// Plain C interface for ctypes; launches on the caller's stream, allocates
// nothing (the wrapper hands in the output and the partition scratch) and
// returns cudaGetLastError().

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;        // threads per tile block
constexpr int QPT = 8;         // consecutive queries per thread
constexpr int TQ = NT * QPT;   // queries per tile
constexpr int SW = 2048;       // store words of a tile held in shared memory
constexpr uint64_t SENT = ~0ull;

// First index in [lo, hi) whose key is >= q (hi if none).
__device__ __forceinline__ int lower_bound(const uint64_t* w, int lo, int hi,
                                           uint64_t q, int kshift) {
  while (lo < hi) {
    int mid = lo + ((hi - lo) >> 1);
    if ((w[mid] >> kshift) < q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// lo[b] for every tile boundary b in [0, ntiles]: the lower bound in the
// live store of query b * TQ, or of the last real query of tile b - 1 when
// that position is past the queries or holds a sentinel.
__global__ void k_partition(const uint64_t* __restrict__ store,
                            long long n_main,
                            const uint64_t* __restrict__ queries,
                            long long nq, long long ntiles, int kshift,
                            long long* __restrict__ lo) {
  long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b > ntiles) return;
  long long at = b * TQ;
  uint64_t q = at < nq ? queries[at] : SENT;
  if (q == SENT && b > 0) {
    // first sentinel of the previous tile, then the query before it
    long long l = at - TQ, h = at < nq ? at : nq;
    long long first = l;
    while (l < h) {
      long long mid = l + ((h - l) >> 1);
      if (queries[mid] != SENT) l = mid + 1; else h = mid;
    }
    if (l > first) q = queries[l - 1];
  }
  long long l = 0, h = q == SENT ? 0 : n_main;
  while (l < h) {
    long long mid = l + ((h - l) >> 1);
    if ((store[mid] >> kshift) < q) l = mid + 1; else h = mid;
  }
  lo[b] = q == SENT ? n_main : l;
}

// Answers of QPT ascending queries over w[0, r) in shared memory: a binary
// search for the first, a galloping search from the previous answer for
// the rest (the gap is a few words).
__device__ __forceinline__ void answer(const uint64_t* w, int r,
                                       const uint64_t (&q)[QPT],
                                       int (&c)[QPT], int kshift,
                                       uint64_t cmask) {
  int p = 0;
  bool first = true;
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    c[k] = 0;
    if (q[k] == SENT) continue;
    if (first) {
      p = lower_bound(w, 0, r, q[k], kshift);
      first = false;
    } else {
      int l = p, h = p, step = 1;
      while (h < r && (w[h] >> kshift) < q[k]) {
        l = h + 1;
        h += step;
        step <<= 1;
      }
      if (h > r) h = r;
      p = lower_bound(w, l, h, q[k], kshift);
    }
    if (p < r) {
      uint64_t e = w[p];
      if ((e >> kshift) == q[k]) c[k] = (int)(e & cmask);
    }
  }
}

__global__ void __launch_bounds__(NT) k_join_tiles(
    const uint64_t* __restrict__ store, long long n_main,
    const uint64_t* __restrict__ queries, long long nq,
    const long long* __restrict__ lo, int* __restrict__ out, int kshift,
    uint64_t cmask) {
  __shared__ __align__(16) uint64_t sw[SW + 2];
  const long long t = blockIdx.x;
  // the tile's store range: every lower bound of the tile lies in
  // [b0, lo[t+1]], and the word at lo[t+1] may match the tile's last query
  const long long b0 = lo[t];
  long long b1 = lo[t + 1] + 1;
  if (b1 > n_main) b1 = n_main;
  const long long r = b1 > b0 ? b1 - b0 : 0;
  if (r > SW) {  // uniform over the block
    // wide range: thread x takes queries x, x + NT, ... of the tile, so a
    // warp's loads fall close together
    const uint64_t* w = store + b0;
    for (int k = 0; k < QPT; ++k) {
      const long long i = t * TQ + (long long)k * NT + threadIdx.x;
      if (i >= nq) break;
      const uint64_t qk = queries[i];
      int ck = 0;
      if (qk != SENT) {
        long long l = 0, h = r;
        while (l < h) {
          const long long mid = l + ((h - l) >> 1);
          if ((w[mid] >> kshift) < qk) l = mid + 1; else h = mid;
        }
        if (l < r) {
          const uint64_t e = w[l];
          if ((e >> kshift) == qk) ck = (int)(e & cmask);
        }
      }
      out[i] = ck;
    }
    return;
  }

  // short range: through shared memory.  Word b0 + k goes to w[k]; w
  // starts one slot in when b0's address is not a multiple of 16 (the word
  // before the range is then copied too), so that whole 16-byte pairs can
  // be copied
  const int odd = (int)((((uintptr_t)(store + b0)) >> 3) & 1);
  const bool s16 = (((uintptr_t)store) & 15) == 0;  // then b0 - odd >= 0
  const uint64_t* src = store + (b0 - odd);
  const int end = odd + (int)r;
  for (int x = 2 * threadIdx.x; x < end; x += 2 * NT) {
    if (s16 && x + 1 < end) {
      __pipeline_memcpy_async(sw + x, src + x, 16);
    } else {
      if (x >= odd) sw[x] = src[x];
      if (x + 1 < end) sw[x + 1] = src[x + 1];
    }
  }
  __pipeline_commit();

  // this thread's QPT consecutive queries
  uint64_t q[QPT];
  int c[QPT];
  const long long q0 = t * TQ + (long long)threadIdx.x * QPT;
  const bool full = q0 + QPT <= nq;
  if (full && (((uintptr_t)queries) & 15) == 0) {  // q0 is even
    const ulonglong2* src = (const ulonglong2*)(queries + q0);
#pragma unroll
    for (int k = 0; k < QPT / 2; ++k) {
      ulonglong2 v = src[k];
      q[2 * k] = v.x;
      q[2 * k + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < QPT; ++k) q[k] = q0 + k < nq ? queries[q0 + k] : SENT;
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  answer(sw + odd, (int)r, q, c, kshift, cmask);

  if (full && (((uintptr_t)out) & 15) == 0) {
    int4* dst = (int4*)(out + q0);
#pragma unroll
    for (int k = 0; k < QPT / 4; ++k)
      dst[k] = make_int4(c[4 * k], c[4 * k + 1], c[4 * k + 2], c[4 * k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < QPT; ++k)
      if (q0 + k < nq) out[q0 + k] = c[k];
  }
}

}  // namespace

extern "C" {

// Scratch words (int64) the caller provides for nq queries.
long long count_join_scratch_words(long long nq) {
  return (nq + TQ - 1) / TQ + 1;
}

int count_join_launch(const void* store, long long n_main,
                      const void* queries, long long nq, void* out,
                      void* scratch, int key_bits, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int kshift = 64 - key_bits;
  int cbits = (kshift < 32 ? kshift : 32) - 1;
  uint64_t cmask = (1ull << cbits) - 1;
  if (nq > 0) {
    long long ntiles = (nq + TQ - 1) / TQ;
    int pb = 128;
    k_partition<<<(unsigned)((ntiles + 1 + pb - 1) / pb), pb, 0, st>>>(
        (const uint64_t*)store, n_main, (const uint64_t*)queries, nq, ntiles,
        kshift, (long long*)scratch);
    k_join_tiles<<<(unsigned)ntiles, NT, 0, st>>>(
        (const uint64_t*)store, n_main, (const uint64_t*)queries, nq,
        (const long long*)scratch, (int*)out, kshift, cmask);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
