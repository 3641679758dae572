// Dedup-merge of two sorted 128-bit k-mer streams: the Contiger's node-store
// fold (kernel K3).
//
// Replaces the TPU kernel sh_assembly_tpu/ops/merge128_pallas.py:
// merge128_planes.  Stream A (the node store, na live entries) and stream B
// (the flush survivors, sentinel tail allowed) each hold (hi, lo, nflag)
// triples in ascending (hi, lo, nflag) order: hi and lo are the
// left-aligned packed k-mer as unsigned words, nflag is the inverted seed
// flag (0 = seed).  The output is their union in the same order with one
// entry per (hi, lo): the first copy of each run, whose nflag is the run's
// minimum, so seed flags are ORed.  The all-ones (hi, lo) pair is the
// sentinel and is dropped.  n_live may exceed the output capacity: entries
// beyond it are not written (the caller raises on the overflow), and the
// output tail past n_live is filled with sentinels (nflag 1).
//
// What bounds it on an H100: bytes.  Per element it does one 17-byte load
// per pass and a few compares, so its floor is reading both streams once
// and writing the output once.  It is laid out like kernel K1
// (merge_dedup.cu): tiles of TILE merged positions cut by merge-path
// co-ranks on the (hi, lo, nflag) order, so blocks need nothing from each
// other but one scan of per-tile survivor counts:
//   1. k_partition   co-rank of every tile boundary (binary search)
//   2. k_tile_count  per tile: merged in shared memory, survivors counted
//                    (first of its (hi, lo) run, not the sentinel; a run
//                    that crosses a tile looks one element back)
//   3. k_tile_scan   one block scans the counts: each tile's output offset
//                    and n_live
//   4. k_tile_write  per tile: merged again, survivors written at their
//                    ranks
//   5. k_fill_tail   sentinel fill of the output beyond n_live
// The TPU kernel's 4-plane packing and source tag are not carried over:
// the flag travels in its own byte array.
//
// Plain C interface for ctypes; launches on the caller's stream, allocates
// nothing (the wrapper hands in scratch) and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int NT = 256;               // threads per tile block
constexpr int ITEMS = 8;              // merged elements per thread
constexpr int TILE = NT * ITEMS;      // merged elements per tile
constexpr int SCAN_NT = 1024;         // threads of the single scan block
constexpr uint64_t SENT = ~0ull;

struct Ent {
  uint64_t hi, lo;
  unsigned f;
};

__device__ __forceinline__ bool less(const Ent& a, const Ent& b) {
  if (a.hi != b.hi) return a.hi < b.hi;
  if (a.lo != b.lo) return a.lo < b.lo;
  return a.f < b.f;
}

__device__ __forceinline__ bool same_kmer(const Ent& a, const Ent& b) {
  return a.hi == b.hi && a.lo == b.lo;
}

__device__ __forceinline__ bool is_sent(const Ent& a) {
  return a.hi == SENT && a.lo == SENT;
}

struct Geo {
  const uint64_t* ahi;
  const uint64_t* alo;
  const uint8_t* af;
  long long na;
  const uint64_t* bhi;
  const uint64_t* blo;
  const uint8_t* bf;
  long long nb;
};

__device__ __forceinline__ Ent ent_a(const Geo& g, long long i) {
  return Ent{g.ahi[i], g.alo[i], g.af[i]};
}

__device__ __forceinline__ Ent ent_b(const Geo& g, long long i) {
  return Ent{g.bhi[i], g.blo[i], g.bf[i]};
}

// Number of A elements among the first d merged elements.  An A element
// precedes a B element iff it is strictly smaller; equal triples are equal
// entries, so the tie rule does not change the output.
__device__ long long corank(const Geo& g, long long d) {
  long long lo = d - g.nb > 0 ? d - g.nb : 0;
  long long hi = d < g.na ? d : g.na;
  while (lo < hi) {
    long long i = (lo + hi) >> 1;
    if (less(ent_a(g, i), ent_b(g, d - i - 1))) lo = i + 1; else hi = i;
  }
  return lo;
}

__global__ void k_partition(Geo g, long long n, long long ntiles,
                            long long* co) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t > ntiles) return;
  long long d = t * TILE;
  if (d > n) d = n;
  co[t] = corank(g, d);
}

// Shared state of one tile: its merged elements and the element before it.
struct TileSmem {
  uint64_t hi[TILE];
  uint64_t lo[TILE];
  uint8_t f[TILE];
  uint64_t prev_hi, prev_lo;
  int has_prev;
};

__device__ __forceinline__ Ent at(const TileSmem& s, int p) {
  return Ent{s.hi[p], s.lo[p], s.f[p]};
}

// Merge tile t into s (length returned) and fill prev.
__device__ int load_tile(const Geo& g, long long n, const long long* co,
                         long long t, TileSmem& s) {
  long long d0 = t * TILE;
  long long d1 = d0 + TILE < n ? d0 + TILE : n;
  long long i0 = co[t], i1 = co[t + 1];
  long long j0 = d0 - i0, j1 = d1 - i1;
  int la = (int)(i1 - i0), lb = (int)(j1 - j0);
  int len = la + lb;
  for (int x = threadIdx.x; x < len; x += NT) {
    Ent e = x < la ? ent_a(g, i0 + x) : ent_b(g, j0 + x - la);
    s.hi[x] = e.hi;
    s.lo[x] = e.lo;
    s.f[x] = (uint8_t)e.f;
  }
  if (threadIdx.x == 0) {
    // the merged element before the tile is the larger of the last A and
    // the last B consumed
    s.has_prev = d0 > 0;
    if (d0 > 0) {
      Ent p;
      if (i0 == 0) p = ent_b(g, j0 - 1);
      else if (j0 == 0) p = ent_a(g, i0 - 1);
      else {
        Ent pa = ent_a(g, i0 - 1), pb = ent_b(g, j0 - 1);
        p = less(pa, pb) ? pb : pa;
      }
      s.prev_hi = p.hi;
      s.prev_lo = p.lo;
    }
  }
  __syncthreads();
  // thread-level merge path inside the tile: A part [0, la), B part
  // [la, len) of the shared arrays
  int d = threadIdx.x * ITEMS;
  if (d > len) d = len;
  int lo = d - lb > 0 ? d - lb : 0;
  int hi = d < la ? d : la;
  while (lo < hi) {
    int i = (lo + hi) >> 1;
    if (less(at(s, i), at(s, la + d - i - 1))) lo = i + 1; else hi = i;
  }
  int i = lo, j = d - lo;
  Ent v[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    if (d + k < len) {
      bool take_a = j >= lb || (i < la && less(at(s, i), at(s, la + j)));
      v[k] = take_a ? at(s, i) : at(s, la + j);
      if (take_a) ++i; else ++j;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    if (d + k < len) {
      s.hi[d + k] = v[k].hi;
      s.lo[d + k] = v[k].lo;
      s.f[d + k] = (uint8_t)v[k].f;
    }
  }
  __syncthreads();
  return len;
}

// Merged position p survives: not the sentinel and first of its run.
__device__ __forceinline__ bool keep_at(const TileSmem& s, int p) {
  Ent e = at(s, p);
  if (is_sent(e)) return false;
  if (p > 0) return !same_kmer(at(s, p - 1), e);
  return !s.has_prev || s.prev_hi != e.hi || s.prev_lo != e.lo;
}

__global__ void __launch_bounds__(NT) k_tile_count(
    Geo g, long long n, const long long* co, long long* tkeep) {
  using Reduce = cub::BlockScan<long long, NT>;
  __shared__ TileSmem s;
  __shared__ typename Reduce::TempStorage tmp;
  long long t = blockIdx.x;
  int len = load_tile(g, n, co, t, s);
  long long keep = 0;
  int d = threadIdx.x * ITEMS;
  for (int k = 0; k < ITEMS; ++k)
    if (d + k < len && keep_at(s, d + k)) ++keep;
  long long x, agg;
  Reduce(tmp).ExclusiveSum(keep, x, agg);
  if (threadIdx.x == 0) tkeep[t] = agg;
}

__global__ void __launch_bounds__(SCAN_NT) k_tile_scan(
    long long ntiles, const long long* tkeep, long long* toff,
    long long* meta) {
  using Scan = cub::BlockScan<long long, SCAN_NT>;
  __shared__ typename Scan::TempStorage tmp;
  long long per = (ntiles + SCAN_NT - 1) / SCAN_NT;
  long long t0 = threadIdx.x * per;
  long long t1 = t0 + per < ntiles ? t0 + per : ntiles;
  long long keep = 0;
  for (long long t = t0; t < t1; ++t) keep += tkeep[t];
  long long pre, agg;
  Scan(tmp).ExclusiveSum(keep, pre, agg);
  for (long long t = t0; t < t1; ++t) {
    toff[t] = pre;
    pre += tkeep[t];
  }
  if (threadIdx.x == 0) meta[0] = agg;
}

__global__ void __launch_bounds__(NT) k_tile_write(
    Geo g, long long n, const long long* co, const long long* toff,
    uint64_t* ohi, uint64_t* olo, uint8_t* of, long long out_cap) {
  using Scan = cub::BlockScan<long long, NT>;
  __shared__ TileSmem s;
  __shared__ typename Scan::TempStorage tmp;
  long long t = blockIdx.x;
  int len = load_tile(g, n, co, t, s);
  long long keep = 0;
  int d = threadIdx.x * ITEMS;
  for (int k = 0; k < ITEMS; ++k)
    if (d + k < len && keep_at(s, d + k)) ++keep;
  long long rank, agg;
  Scan(tmp).ExclusiveSum(keep, rank, agg);
  long long pos = toff[t] + rank;
  for (int k = 0; k < ITEMS; ++k) {
    int p = d + k;
    if (p < len && keep_at(s, p)) {
      if (pos < out_cap) {
        ohi[pos] = s.hi[p];
        olo[pos] = s.lo[p];
        of[pos] = s.f[p];
      }
      ++pos;
    }
  }
}

__global__ void k_fill_tail(uint64_t* ohi, uint64_t* olo, uint8_t* of,
                            long long out_cap, const long long* meta) {
  long long start = meta[0] < out_cap ? meta[0] : out_cap;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = start + (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < out_cap; i += stride) {
    ohi[i] = SENT;
    olo[i] = SENT;
    of[i] = 1;
  }
}

}  // namespace

extern "C" {

int merge128_tile() { return TILE; }

// Scratch words (int64) the caller provides for ntiles tiles.
long long merge128_scratch_words(long long ntiles) {
  return 3 * (ntiles + 1);
}

int merge128_launch(const void* ahi, const void* alo, const void* af,
                    long long na, const void* bhi, const void* blo,
                    const void* bf, long long nb, void* ohi, void* olo,
                    void* of, long long out_cap, void* scratch, void* meta,
                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Geo g;
  g.ahi = (const uint64_t*)ahi;
  g.alo = (const uint64_t*)alo;
  g.af = (const uint8_t*)af;
  g.na = na;
  g.bhi = (const uint64_t*)bhi;
  g.blo = (const uint64_t*)blo;
  g.bf = (const uint8_t*)bf;
  g.nb = nb;
  long long n = na + nb;
  long long ntiles = (n + TILE - 1) / TILE;
  long long* co = (long long*)scratch;
  long long* tkeep = co + ntiles + 1;
  long long* toff = tkeep + ntiles + 1;
  if (ntiles > 0) {
    int pb = 256;
    k_partition<<<(unsigned)((ntiles + 1 + pb - 1) / pb), pb, 0, st>>>(
        g, n, ntiles, co);
    k_tile_count<<<(unsigned)ntiles, NT, 0, st>>>(g, n, co, tkeep);
  }
  k_tile_scan<<<1, SCAN_NT, 0, st>>>(ntiles, tkeep, toff, (long long*)meta);
  if (ntiles > 0)
    k_tile_write<<<(unsigned)ntiles, NT, 0, st>>>(
        g, n, co, toff, (uint64_t*)ohi, (uint64_t*)olo, (uint8_t*)of,
        out_cap);
  if (out_cap > 0) {
    long long blocks = (out_cap + 255) / 256;
    if (blocks > 4096) blocks = 4096;
    k_fill_tail<<<(unsigned)blocks, 256, 0, st>>>(
        (uint64_t*)ohi, (uint64_t*)olo, (uint8_t*)of, out_cap,
        (const long long*)meta);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
