// The node join: the index of each 128-bit query pair in a table of pairs
// (kernel K7).
//
// Replaces the JAX package's sort-join, sh_assembly_tpu/ops/kmerpack.py:
// join2, which the jax.jit probe programs of the Contiger (contiger.py:
// phantom_candidates and build_oriented_graph) and the mesh Contiger's node
// join call.  There it is a 3-key sort of table and queries together, a
// run-id cummax and a second sort back to query order, because a gather
// costs about a hundred times a streaming sort pass on a TPU.  On the card
// a lookup costs one or two random 32-byte sectors, so this is a hash join.
//
// What one launch computes, for a table of n rows (hi, lo) and q queries:
//   out[i] = the largest row r with (hi[r], lo[r]) == (qhi[i], qlo[i]), or
//            -1 where no row holds the pair.
// The table may be in any order and may hold a pair many times (the
// sentinel pad rows of the closure's padded store, the node pad of the
// graph): the largest row answers, as the JAX cummax gives.  Any 128-bit
// value is a key, the (-1, -1) sentinel included.
//
// How: two kernels on one open-addressing table of m slots (a power of
// two, m >= 2n: a load of at most one half), 32 bytes a slot: the pair and
// the row.  The launcher fills it with ones (row -1 = empty).
//   k_build, a thread a row: the lanes of a warp that hold the same pair
//   (__match_any_sync on both words) elect their highest lane, whose row is
//   the group's largest, and only it inserts: so the millions of identical
//   pad rows, which lie together, cost one atomic a warp and not one a row.
//   It claims the first slot of its linear probe sequence whose row is -1
//   (atomicCAS), or stops at the slot whose row holds its pair (compared
//   in the table itself, which never changes) and raises the slot's row
//   with atomicMax.  The claimer writes the pair into the slot, which only
//   the next kernel reads.  Which thread claims a slot changes from run to
//   run; the slot's final row does not: max is order-free.
//   k_probe, a thread a query: coalesced reads of the query words, the same
//   probe sequence over the slots (two 16-byte loads of one 32-byte sector
//   a step) until the pair or an empty slot, a coalesced int32 store.
// What bounds it on an H100: bytes.  The floor is reading the table and
// the queries once (16 bytes a row or query) and writing 4 bytes a query.
// The slots add 32 bytes a row written and, a query, one random sector and
// about half a sector more at a load of one half; at the real shapes
// (2^24 rows, 2^27 or 2^28 queries) the table is 0.5-1 GiB, far beyond
// the 50 MB L2, so the probe's random sectors are what the kernel waits
// on, and a table at a lower load would only cost more bytes to build.

#include <cuda_runtime.h>

#include <climits>

namespace {

typedef unsigned long long u64;

constexpr int NT = 256;                   // threads a block
constexpr int SLOT_WORDS = 4;             // hi, lo, row (low half), unused
constexpr int BLOCKS_PER_SM = 32;         // grid-stride launches

__device__ __forceinline__ u64 fmix64(u64 h) {
  h ^= h >> 33;
  h *= 0xFF51AFD7ED558CCDull;
  h ^= h >> 33;
  h *= 0xC4CEB9FE1A85EC53ull;
  h ^= h >> 33;
  return h;
}

// First slot of a pair's probe sequence.  k-mer words are left-aligned
// (the low bits of lo, or all of lo at k <= 32, are zero), so both words
// go through the finaliser.
__device__ __forceinline__ u64 home(u64 hi, u64 lo, u64 mask) {
  return fmix64(hi ^ fmix64(lo + 0x9E3779B97F4A7C15ull)) & mask;
}

__device__ __forceinline__ int* row_of(u64* slots, u64 s) {
  return reinterpret_cast<int*>(slots + SLOT_WORDS * s + 2);
}

__global__ void __launch_bounds__(NT)
    k_build(const u64* __restrict__ thi, const u64* __restrict__ tlo,
            long long n, u64* __restrict__ slots, u64 mask) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * NT;
  // every lane of a warp runs the same iterations (base is the warp's)
  for (long long base = (long long)blockIdx.x * NT + (threadIdx.x & ~31);
       base < n; base += stride) {
    const long long r = base + lane;
    const unsigned act = __ballot_sync(0xFFFFFFFFu, r < n);
    if (r >= n) continue;
    const u64 hi = thi[r], lo = tlo[r];
    // lanes with this pair; rows rise with the lane, so the highest lane
    // holds the group's largest row
    const unsigned same =
        __match_any_sync(act, hi) & __match_any_sync(act, lo);
    if (lane != 31 - __clz(same)) continue;
    const int row = (int)r;
    for (u64 s = home(hi, lo, mask);; s = (s + 1) & mask) {
      int* pr = row_of(slots, s);
      const int prev = atomicCAS(pr, -1, row);
      if (prev == -1) {
        *reinterpret_cast<ulonglong2*>(slots + SLOT_WORDS * s) =
            make_ulonglong2(hi, lo);
        break;
      }
      if (thi[prev] == hi && tlo[prev] == lo) {
        if (prev < row) atomicMax(pr, row);
        break;
      }
    }
  }
}

__global__ void __launch_bounds__(NT)
    k_probe(const u64* __restrict__ qhi, const u64* __restrict__ qlo,
            long long q, const u64* __restrict__ slots, u64 mask,
            int* __restrict__ out) {
  const long long stride = (long long)gridDim.x * NT;
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < q;
       i += stride) {
    const u64 hi = qhi[i], lo = qlo[i];
    int got;
    for (u64 s = home(hi, lo, mask);; s = (s + 1) & mask) {
      const ulonglong2* p =
          reinterpret_cast<const ulonglong2*>(slots + SLOT_WORDS * s);
      const ulonglong2 key = __ldg(p);
      const int row = (int)__ldg(p + 1).x;
      if (row < 0) {
        got = -1;
        break;
      }
      if (key.x == hi && key.y == lo) {
        got = row;
        break;
      }
    }
    out[i] = got;
  }
}

long long grid_for(long long n, int sms) {
  const long long blocks = (n + NT - 1) / NT;
  const long long cap = (long long)sms * BLOCKS_PER_SM;
  return blocks < cap ? blocks : cap;
}

}  // namespace

extern "C" {

// Launch on `stream`.  thi/tlo (n table rows) and qhi/qlo (q queries) are
// u64 words; slots holds 4 * m u64 words, m a power of two >= 2 * n
// (overwritten); out receives q int32 rows.  n < 2^31.  Returns the CUDA
// error of the first call that failed (0 = none).
int node_join_launch(const void* thi, const void* tlo, long long n,
                     const void* qhi, const void* qlo, long long q,
                     void* slots, long long m, void* out, void* stream) {
  if (q <= 0) return 0;
  if (n < 0 || n > INT_MAX || m < 1 || m < 2 * n || (m & (m - 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(slots, 0xFF, (size_t)m * SLOT_WORDS * sizeof(u64),
                        st);
  if (e != cudaSuccess) return (int)e;
  u64 mask = (u64)m - 1;
  if (n > 0) {
    void* args[] = {&thi, &tlo, &n, &slots, &mask};
    e = cudaLaunchKernel(k_build, dim3((unsigned)grid_for(n, sms)), dim3(NT),
                         args, 0, st);
    if (e != cudaSuccess) return (int)e;
  }
  void* args[] = {&qhi, &qlo, &q, &slots, &mask, &out};
  return (int)cudaLaunchKernel(k_probe, dim3((unsigned)grid_for(q, sms)),
                               dim3(NT), args, 0, st);
}

}  // extern "C"
