// The node join: the index of each 128-bit query pair in a table of pairs
// (kernel K7).
//
// Replaces the JAX package's sort-join, sh_assembly_tpu/ops/kmerpack.py:
// join2, which the jax.jit probe programs of the Contiger (contiger.py:
// phantom_candidates and build_oriented_graph) and the mesh Contiger's node
// join call.  There it is a 3-key sort of table and queries together, a
// run-id cummax and a second sort back to query order, because a gather
// costs about a hundred times a streaming sort pass on a TPU.  On the card
// a lookup costs one random DRAM access, so this is a hash join.
//
// What a probe answers, for a table of n rows (hi, lo) and q queries:
//   out[i] = the largest row r with (hi[r], lo[r]) == (qhi[i], qlo[i]), or
//            -1 where no row holds the pair.
// The table may be in any order and may hold a pair many times (the
// sentinel pad rows of the closure's padded store, the node pad of the
// graph): the largest row answers, as the JAX cummax gives.  Any 128-bit
// value is a key, the (-1, -1) sentinel included.
//
// The table (ops/node_join_cuda.py: NodeTable) lives as long as its
// caller wants: the Contiger builds it once for the phantom closure,
// inserts each round's appended rows and probes it again for the graph.
//   slots: buckets of eight 8-byte slots, 64 bytes aligned (two 32-byte
//     sectors of one L2 line, one DRAM access).  A slot holds a 32-bit
//     fingerprint (the high half of the pair's 64-bit hash; the low bits
//     pick the home bucket) and the 32-bit row; all ones is empty.  At
//     least 2n slots: a load of at most one half.
//   pairs: a row-major (hi, lo) copy of the table, so that confirming a
//     fingerprint reads one 16-byte sector and not two.
// k_insert, a thread a row of [r0, r1): writes the row's pair into pairs;
//   the lanes of a warp that hold the same pair (__match_any_sync on both
//   words) elect their highest lane, whose row is the group's largest, and
//   only it inserts: so the millions of identical pad rows, which lie
//   together, cost one atomic a warp and not one a row.  It reads its home
//   bucket once from L2 and walks its slots, then the next bucket's: the
//   first empty slot is claimed with a 64-bit atomicCAS of (fingerprint,
//   row); a slot whose fingerprint matches and whose row holds the pair
//   (compared in the table's own words, which never change while it runs)
//   has its row raised by atomicMax.  A slot is never emptied, so the
//   occupied slots of a bucket are a prefix and a bucket spills into the
//   next only when full.  Which thread claims a slot changes from run to
//   run; the slot's final row does not: max is order-free.  The closure's
//   padded store inserts only its real rows and one `tail` row for its
//   sentinel pad (the pad's largest row), so 4.5 M pad rows cost nothing.
// k_probe, a thread a query: coalesced reads of the query words, the four
//   16-byte quarters of its home bucket loaded together (one 64-byte
//   line), its slots walked in order to the first empty one (a miss) or
//   the first whose fingerprint matches and whose row's pair, one 16-byte
//   load of pairs, is the query's; the next bucket only when the home
//   bucket is full.  A coalesced int32 store.
// What bounds it on an H100: random DRAM accesses.  The floor is reading
// the rows and queries once (16 bytes each) and writing 4 bytes a query;
// beyond it a query costs one random 64-byte access, and a hit one 16-byte
// sector more.  At the real shapes (2^24 rows, 2^27 or 2^28 queries) the
// slots are 256 MB, five times the 50 MB L2, so those accesses are what
// the probe waits on: it issues about 28 G of them a second, where the old
// table of 32-byte slots walked about 2.5 slots (one or two lines) a miss.
// Its slots are a quarter of the old table's bytes to fill and to hold.
// Four lanes reading a query's bucket together (a warp instruction on
// eight lines) and a load of one quarter (fewer full buckets) took the
// same time, so the probe stays a thread a query.

#include <cuda_runtime.h>

#include <climits>

namespace {

typedef unsigned long long u64;

constexpr int NT = 256;                   // threads a block
constexpr int BUCKET = 8;                 // slots a bucket (64 bytes)
constexpr int BLOCKS_PER_SM = 32;         // grid-stride launches
constexpr unsigned EMPTY_ROW = 0xFFFFFFFFu;
constexpr u64 EMPTY = ~0ull;              // fingerprint and row all ones
constexpr u64 SENT = ~0ull;               // the sentinel pair's words

__device__ __forceinline__ u64 fmix64(u64 h) {
  h ^= h >> 33;
  h *= 0xFF51AFD7ED558CCDull;
  h ^= h >> 33;
  h *= 0xC4CEB9FE1A85EC53ull;
  h ^= h >> 33;
  return h;
}

// The pair's 64-bit hash: its low bits pick the home bucket, its high half
// is the fingerprint.  k-mer words are left-aligned (the low bits of lo,
// or all of lo at k <= 32, are zero), so both words go through the
// finaliser.
__device__ __forceinline__ u64 hash2(u64 hi, u64 lo) {
  return fmix64(hi ^ fmix64(lo + 0x9E3779B97F4A7C15ull));
}

__device__ __forceinline__ void insert(u64 hi, u64 lo, int row,
                                       const u64* __restrict__ thi,
                                       const u64* __restrict__ tlo,
                                       u64* __restrict__ slots, u64 bmask) {
  const u64 h = hash2(hi, lo);
  const unsigned fp = (unsigned)(h >> 32);
  const u64 mine = (u64)fp | ((u64)(unsigned)row << 32);
  for (u64 b = h & bmask;; b = (b + 1) & bmask) {
    u64* bucket = slots + BUCKET * b;
    // one read of the bucket from L2 (other blocks write it); a slot read
    // empty here may have been claimed since, which its CAS reports
    u64 v[BUCKET];
#pragma unroll
    for (int c = 0; c < BUCKET / 2; ++c) {
      const ulonglong2 w =
          __ldcg(reinterpret_cast<const ulonglong2*>(bucket) + c);
      v[2 * c] = w.x;
      v[2 * c + 1] = w.y;
    }
#pragma unroll
    for (int j = 0; j < BUCKET; ++j) {
      u64 s = v[j];
      if (s == EMPTY) {
        s = atomicCAS(bucket + j, EMPTY, mine);
        if (s == EMPTY) return;
      }
      if ((unsigned)s == fp) {
        const int prev = (int)(s >> 32);
        if (thi[prev] == hi && tlo[prev] == lo) {
          if (prev < row)
            atomicMax(reinterpret_cast<int*>(bucket + j) + 1, row);
          return;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(NT)
    k_insert(const u64* __restrict__ thi, const u64* __restrict__ tlo,
             long long r0, long long r1, long long tail,
             u64* __restrict__ slots, u64 bmask,
             ulonglong2* __restrict__ pairs) {
  const int lane = threadIdx.x & 31;
  if (tail >= 0 && blockIdx.x == 0 && threadIdx.x == 0) {
    pairs[tail] = make_ulonglong2(SENT, SENT);
    insert(SENT, SENT, (int)tail, thi, tlo, slots, bmask);
  }
  const long long stride = (long long)gridDim.x * NT;
  // every lane of a warp runs the same iterations (base is the warp's)
  for (long long base = r0 + (long long)blockIdx.x * NT + (threadIdx.x & ~31);
       base < r1; base += stride) {
    const long long r = base + lane;
    const unsigned act = __ballot_sync(0xFFFFFFFFu, r < r1);
    if (r >= r1) continue;
    const u64 hi = thi[r], lo = tlo[r];
    pairs[r] = make_ulonglong2(hi, lo);
    // lanes with this pair; rows rise with the lane, so the highest lane
    // holds the group's largest row
    const unsigned same =
        __match_any_sync(act, hi) & __match_any_sync(act, lo);
    if (lane != 31 - __clz(same)) continue;
    insert(hi, lo, (int)r, thi, tlo, slots, bmask);
  }
}

__global__ void __launch_bounds__(NT)
    k_probe(const u64* __restrict__ qhi, const u64* __restrict__ qlo,
            long long q, const uint4* __restrict__ slots, u64 bmask,
            const ulonglong2* __restrict__ pairs, int* __restrict__ out) {
  const long long stride = (long long)gridDim.x * NT;
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < q;
       i += stride) {
    const u64 hi = qhi[i], lo = qlo[i];
    const u64 h = hash2(hi, lo);
    const unsigned fp = (unsigned)(h >> 32);
    int got = -2;  // -2: not decided yet
    for (u64 b = h & bmask; got == -2; b = (b + 1) & bmask) {
      // the bucket's four 16-byte quarters, loads in flight together
      uint4 v[BUCKET / 2];
#pragma unroll
      for (int c = 0; c < BUCKET / 2; ++c)
        v[c] = __ldg(slots + (BUCKET / 2) * b + c);
      // slots in order: the first empty one ends the sequence (a miss)
#pragma unroll
      for (int j = 0; j < BUCKET; ++j) {
        const unsigned f = j & 1 ? v[j / 2].z : v[j / 2].x;
        const unsigned row = j & 1 ? v[j / 2].w : v[j / 2].y;
        if (got != -2) continue;
        if (row == EMPTY_ROW) {
          got = -1;
        } else if (f == fp) {
          const ulonglong2 p = __ldg(pairs + row);
          if (p.x == hi && p.y == lo) got = (int)row;
        }
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

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return e;
}

bool bad_buckets(long long nb) {
  return nb < 1 || (nb & (nb - 1)) || nb > (1ll << 31);
}

}  // namespace

extern "C" {

// Insert rows [r0, r1) of the table thi/tlo (u64 words of n rows) into
// the slots (8 * nb u64 words, nb buckets, a power of two, 8 nb >= 2 n)
// and write their pairs into `pairs` (2n u64 words); with tail >= 0 also
// insert the sentinel pair at row tail (whose words must be the sentinel).
// fill != 0 empties the slots first (a build); fill == 0 adds rows to a
// built table (an append: every row that already holds an inserted row's
// pair must be smaller than it).  Launch on `stream`.  Returns the CUDA
// error of the first call that failed (0 = none).
int node_table_insert(const void* thi, const void* tlo, long long n,
                      long long r0, long long r1, long long tail,
                      void* slots, long long nb, void* pairs, int fill,
                      void* stream) {
  if (n < 0 || n > INT_MAX || r0 < 0 || r1 < r0 || r1 > n || tail >= n ||
      bad_buckets(nb) || 8 * nb < 2 * n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int sms = 0;
  cudaError_t e = sm_count(&sms);
  if (e == cudaSuccess && fill)
    e = cudaMemsetAsync(slots, 0xFF, (size_t)nb * BUCKET * sizeof(u64), st);
  if (e != cudaSuccess) return (int)e;
  if (r1 == r0 && tail < 0) return 0;
  u64 bmask = (u64)nb - 1;
  void* args[] = {&thi, &tlo, &r0, &r1, &tail, &slots, &bmask, &pairs};
  const long long rows = r1 > r0 ? r1 - r0 : 1;
  return (int)cudaLaunchKernel(k_insert, dim3((unsigned)grid_for(rows, sms)),
                               dim3(NT), args, 0, st);
}

// Probe q queries (qhi/qlo u64 words) against a built table: out receives
// q int32 rows.  Launch on `stream`.  Returns the CUDA error of the first
// call that failed (0 = none).
int node_table_probe(const void* qhi, const void* qlo, long long q,
                     const void* slots, long long nb, const void* pairs,
                     void* out, void* stream) {
  if (q <= 0) return 0;
  if (bad_buckets(nb)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int sms = 0;
  cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  u64 bmask = (u64)nb - 1;
  void* args[] = {&qhi, &qlo, &q, &slots, &bmask, &pairs, &out};
  return (int)cudaLaunchKernel(k_probe, dim3((unsigned)grid_for(q, sms)),
                               dim3(NT), args, 0, st);
}

}  // extern "C"
