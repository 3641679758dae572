// Dedup-merge of two sorted 128-bit k-mer streams: the Contiger's node-store
// fold (kernel K3).
//
// Replaces the TPU kernel sh_assembly_tpu/ops/merge128_pallas.py:
// merge128_planes.  Stream A (the node store, na live entries) and stream B
// (a flush's sorted candidates, sentinel tail allowed) each hold (hi, lo,
// nflag) triples in ascending (hi, lo, nflag) order: hi and lo are the
// left-aligned packed k-mer as unsigned words, nflag is the inverted seed
// flag (0 = seed).  The output is their union in the same order with one
// entry per (hi, lo): the first copy of each run, whose nflag is the run's
// minimum, so seed flags are ORed.  The all-ones (hi, lo) pair is the
// sentinel and is dropped.  n_live may exceed the output capacity: entries
// beyond it are not written (the caller raises on the overflow).  Behind
// the live entries the output is sentinel (nflag 1) up to its capacity.
//
// What bounds it on an H100: bytes.  Per element it does a few compares, so
// its floor is reading A and the live part of B once and writing the live
// result once, 17 bytes an entry.  What a flush hands it is mostly not
// result: the whole candidate buffer, in which every solid k-mer stands
// four times over (the read coverage of one flush) and the masked
// non-solid candidates form a sentinel tail of a fifth of the length.
// Design: one pass over the inputs, three kernels, laid out like kernel K1
// (merge_dedup.cu).
//   1. k_partition   finds B's first sentinel pair (binary search), so the
//                    tail is never loaded, and the merge-path co-rank of
//                    every tile boundary on the (hi, lo, nflag) order (a
//                    tile is TILE merged positions of A and live B).
//   2. k_merge       persistent blocks take tile ids from an atomic
//                    counter.  A tile copies its A and B ranges to shared
//                    memory (hi and lo as asynchronous 16-byte copies, two
//                    entries a copy; the flags four at a time; views at
//                    odd offsets land shifted so that both sides of a copy
//                    are aligned, and nothing outside a range is read).
//                    Each thread merges ITEMS consecutive positions into
//                    registers; an entry survives if it is not the
//                    sentinel and differs from the entry before it (across
//                    a tile boundary: the larger of the last A and the
//                    last B before the tile).  One block scan ranks the
//                    survivors, they are compacted in shared memory, and
//                    the only thing a tile needs from its predecessors, the
//                    output offset, comes by a decoupled look-back: a tile
//                    publishes its survivor count in one 8-byte word with a
//                    status in the top bits, a warp walks back over its
//                    predecessors, 32 at a time, until it meets an
//                    inclusive prefix, and publishes its own.  Tile ids
//                    come from the counter, so every tile waited for
//                    belongs to a block that is already running; the spin
//                    is bounded and traps.  Survivors leave with 16-byte
//                    stores (flags: 4-byte).  The last tile's inclusive
//                    prefix is n_live.
//   3. k_fill_tail   sentinels over [min(n_live, capacity), capacity).
// Measured on an H100 80GB HBM3 at 700 W, at the flush shape (12.1 M
// stored entries, 59.8 M candidates): blocks waiting in the look-back cost
// a quarter of k_merge (0.67 ms with the wait cut out against 0.92 ms).
// Thinning B's part of a tile to the first copy of each k-mer before the
// merge bought nothing (0.92 against 0.91 ms, and 0.63 against 0.57 ms
// against an empty store), and writing survivors from registers while the
// next tile's copies are in flight was slower (1.17 ms): scattered 8-byte
// stores cost more than the staging in shared memory saves.
// The TPU kernel's 4-plane packing and source tag are not carried over:
// the flag travels in its own byte array, so the fold works at every k up
// to 63.
//
// Plain C interface for ctypes; launches on the caller's stream, allocates
// nothing (the wrapper hands in one scratch tensor, whose head the launch
// zeroes on the stream and which also receives n_live) and returns the
// first CUDA error.

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int NT = 256;               // threads per block
constexpr int ITEMS = 15;             // merged elements per thread (odd)
constexpr int TILE = NT * ITEMS;      // merged elements per tile
constexpr int MINB = 3;               // blocks per SM the compiler must fit
static_assert(ITEMS <= 32, "an element's facts are bits of one 32-bit mask");
constexpr uint64_t SENT = ~0ull;

// scratch layout, in 8-byte words: HDR header words and one descriptor for
// each tile (both zeroed by the launch), then the co-ranks
constexpr int HDR = 8;                // nb_live, n, ntiles, tile counter,
constexpr int H_NLIVE = 4;            // n_live
constexpr unsigned long long ST_AGG = 1, ST_INC = 2;
constexpr int ST_SHIFT = 62;
constexpr unsigned long long LOW = (1ull << ST_SHIFT) - 1;

struct Ent {
  uint64_t hi, lo;
  unsigned f;
};

__device__ __forceinline__ bool less(const Ent& a, const Ent& b) {
  if (a.hi != b.hi) return a.hi < b.hi;
  if (a.lo != b.lo) return a.lo < b.lo;
  return a.f < b.f;
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

// Number of A elements among the first d merged elements of A and
// B[0, nb).  An A element precedes a B element iff it is strictly smaller;
// equal triples are equal entries, so the tie rule does not change the
// output.
__device__ long long corank(const Geo& g, long long nb, long long d) {
  long long lo = d - nb > 0 ? d - nb : 0;
  long long hi = d < g.na ? d : g.na;
  while (lo < hi) {
    long long i = (lo + hi) >> 1;
    if (less(ent_a(g, i), ent_b(g, d - i - 1))) lo = i + 1; else hi = i;
  }
  return lo;
}

// One thread per tile boundary t: B's live length (its first sentinel
// pair; every thread walks the same few cache lines) and the co-rank of
// t * TILE.
__global__ void k_partition(Geo g, long long max_tiles, long long* hdr,
                            long long* co) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t > max_tiles) return;
  long long lo = 0, hi = g.nb;
  while (lo < hi) {
    long long mid = (lo + hi) >> 1;
    if (g.bhi[mid] != SENT || g.blo[mid] != SENT) lo = mid + 1; else hi = mid;
  }
  const long long nb_live = lo;
  const long long n = g.na + nb_live;
  const long long ntiles = (n + TILE - 1) / TILE;
  if (t == 0) {
    hdr[0] = nb_live;
    hdr[1] = n;
    hdr[2] = ntiles;
  }
  if (t > ntiles) return;
  const long long d = t * TILE < n ? t * TILE : n;
  co[t] = corank(g, nb_live, d);
}

// Start copying the count words at src into the 16-byte aligned shared
// region reg, pairs as asynchronous 16-byte copies, and return where
// src[0] lands: reg, or reg + 1 when src is not a multiple of 16, so that
// pairs are aligned on both sides.  Nothing outside the range is read.
// reg needs count + 1 words.  The caller waits with
// __pipeline_wait_prior(0) and a barrier.
__device__ __forceinline__ uint64_t* load_words(uint64_t* reg,
                                                const uint64_t* src,
                                                int count) {
  const int odd = (int)((((uintptr_t)src) >> 3) & 1);
  uint64_t* dst = reg + odd;
  if (odd && threadIdx.x == 0 && count > 0) dst[0] = src[0];
  for (int x = odd + 2 * threadIdx.x; x < count; x += 2 * NT) {
    if (x + 1 < count) __pipeline_memcpy_async(dst + x, src + x, 16);
    else dst[x] = src[x];
  }
  return dst;
}

// The same for count flag bytes, four a copy; reg is 4-byte aligned and
// needs count + 3 bytes.
__device__ __forceinline__ uint8_t* load_bytes(uint8_t* reg,
                                               const uint8_t* src,
                                               int count) {
  const int mis = (int)(((uintptr_t)src) & 3);
  uint8_t* dst = reg + mis;
  int head = mis ? 4 - mis : 0;
  if (head > count) head = count;
  if ((int)threadIdx.x < head) dst[threadIdx.x] = src[threadIdx.x];
  for (int x = head + 4 * threadIdx.x; x < count; x += 4 * NT) {
    if (x + 3 < count) {
      __pipeline_memcpy_async(dst + x, src + x, 4);
    } else {
      for (int y = x; y < count; ++y) dst[y] = src[y];
    }
  }
  return dst;
}

using Scan = cub::BlockScan<int, NT>;

struct Shared {                        // k_merge's dynamic shared memory
  __align__(16) uint64_t hi[TILE + 4]; // the tile's A and B ranges, then
  __align__(16) uint64_t lo[TILE + 4]; // its compacted survivors
  __align__(16) uint8_t f[TILE + 16];
  uint64_t last_hi[NT], last_lo[NT];   // each thread's last element
  uint64_t halo[4];                    // hi, lo of A and of B before the tile
  long long tile;
  long long off;
  Scan::TempStorage scan_tmp;
};

__device__ __forceinline__ void publish(unsigned long long* desc, long long t,
                                        unsigned long long status,
                                        long long keep) {
  const unsigned long long x =
      (status << ST_SHIFT) | (unsigned long long)keep;
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(desc + t), "l"(x)
               : "memory");
}

// Spin until tile p's descriptor holds a status; returns it with the count.
__device__ __forceinline__ unsigned long long wait_for(
    const unsigned long long* desc, long long p, long long& keep) {
  unsigned long long x;
  int tries = 0;
  while (true) {
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
                 : "=l"(x)
                 : "l"(desc + p)
                 : "memory");
    if ((x >> ST_SHIFT) != 0) break;
    __nanosleep(20);
    if (++tries > (1 << 24)) __trap();  // a lost tile: fail, do not hang
  }
  keep = (long long)(x & LOW);
  return x >> ST_SHIFT;
}

// Walk back from tile t to the nearest inclusive prefix, publish t's own
// and return the exclusive prefix (the same in every lane).  Run by one
// whole warp, after t's aggregate is published.
__device__ __noinline__ long long look_back(unsigned long long* desc,
                                            long long t, long long agg,
                                            int lane) {
  long long excl = 0;
  for (long long base = t - 1;; base -= 32) {
    const long long p = base - lane;  // lane 0 reads the nearest tile
    long long val = 0;
    unsigned long long st = ST_INC;   // before tile 0: an empty prefix
    if (p >= 0) st = wait_for(desc, p, val);
    const unsigned incl = __ballot_sync(0xFFFFFFFFu, st == ST_INC);
    const int limit = incl ? __ffs(incl) - 1 : 31;
    if (lane > limit) val = 0;
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1)
      val += __shfl_xor_sync(0xFFFFFFFFu, val, o);
    excl += val;
    if (incl) break;
  }
  if (lane == 0) publish(desc, t, ST_INC, excl + agg);
  return excl;
}

__global__ void __launch_bounds__(NT, MINB) k_merge(
    Geo g, long long* hdr, const long long* __restrict__ co,
    uint64_t* __restrict__ ohi, uint64_t* __restrict__ olo,
    uint8_t* __restrict__ of, long long out_cap) {
  extern __shared__ __align__(16) unsigned char shared_raw[];
  Shared& s = *reinterpret_cast<Shared*>(shared_raw);
  const int tid = threadIdx.x;
  const long long n = hdr[1], ntiles = hdr[2];
  unsigned long long* desc = (unsigned long long*)(hdr + HDR);

  while (true) {
    if (tid == 0)
      s.tile = (long long)atomicAdd((unsigned long long*)(hdr + 3), 1ull);
    __syncthreads();
    const long long t = s.tile;
    if (t >= ntiles) break;

    const long long d0 = t * TILE;
    const long long d1 = d0 + TILE < n ? d0 + TILE : n;
    const long long i0 = co[t], i1 = co[t + 1];
    const long long j0 = d0 - i0, j1 = d1 - i1;
    const int la = (int)(i1 - i0);
    const int lb = (int)(j1 - j0);
    // A's part from the start of each array, B's part behind it
    const int wb = (la + 3) & ~1, fb = (la + 7) & ~3;
    const uint64_t* sah = load_words(s.hi, g.ahi + i0, la);
    const uint64_t* sal = load_words(s.lo, g.alo + i0, la);
    const uint8_t* saf = load_bytes(s.f, g.af + i0, la);
    const uint64_t* sbh = load_words(s.hi + wb, g.bhi + j0, lb);
    const uint64_t* sbl = load_words(s.lo + wb, g.blo + j0, lb);
    const uint8_t* sbf = load_bytes(s.f + fb, g.bf + j0, lb);
    __pipeline_commit();
    if (tid == 0) s.halo[0] = i0 > 0 ? g.ahi[i0 - 1] : 0;
    if (tid == 1) s.halo[1] = i0 > 0 ? g.alo[i0 - 1] : 0;
    if (tid == 2) s.halo[2] = j0 > 0 ? g.bhi[j0 - 1] : 0;
    if (tid == 3) s.halo[3] = j0 > 0 ? g.blo[j0 - 1] : 0;
    __pipeline_wait_prior(0);
    __syncthreads();

    uint64_t vh[ITEMS], vl[ITEMS];
    unsigned fm = 0;  // bit k: the flag of element k
    // this thread's ITEMS merged positions, by merge path, into registers
    const int len = la + lb;
    int d = tid * ITEMS;
    if (d > len) d = len;
    const int cnt = len - d < ITEMS ? len - d : ITEMS;
    int lo = d - lb > 0 ? d - lb : 0;
    int hi = d < la ? d : la;
    while (lo < hi) {
      const int i = (lo + hi) >> 1;
      const int j = d - i - 1;
      if (less(Ent{sah[i], sal[i], saf[i]}, Ent{sbh[j], sbl[j], sbf[j]}))
        lo = i + 1;
      else
        hi = i;
    }
    int i = lo, j = d - lo;
    // an exhausted side reads as an entry above every real one
    const Ent top{SENT, SENT, 0xFFu};
    Ent ea = i < la ? Ent{sah[i], sal[i], saf[i]} : top;
    Ent eb = j < lb ? Ent{sbh[j], sbl[j], sbf[j]} : top;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      if (less(ea, eb)) {
        vh[k] = ea.hi;
        vl[k] = ea.lo;
        fm |= (ea.f & 1u) << k;
        ++i;
        ea = i < la ? Ent{sah[i], sal[i], saf[i]} : top;
      } else {
        vh[k] = eb.hi;
        vl[k] = eb.lo;
        fm |= (eb.f & 1u) << k;
        ++j;
        eb = j < lb ? Ent{sbh[j], sbl[j], sbf[j]} : top;
      }
    }
    s.last_hi[tid] = vh[ITEMS - 1];
    s.last_lo[tid] = vl[ITEMS - 1];
    __syncthreads();  // also: every thread is done reading the ranges

    // an entry survives if it is not the sentinel and differs from the
    // merged entry before it
    bool has_prev;
    uint64_t ph, pl;
    if (d > 0) {  // then the thread before is full
      has_prev = true;
      ph = s.last_hi[tid - 1];
      pl = s.last_lo[tid - 1];
    } else {
      // before the tile: the larger of the last A and the last B consumed
      has_prev = d0 > 0;
      const bool a_last = j0 == 0 ||
          (i0 > 0 && (s.halo[0] > s.halo[2] ||
                      (s.halo[0] == s.halo[2] && s.halo[1] >= s.halo[3])));
      ph = a_last ? s.halo[0] : s.halo[2];
      pl = a_last ? s.halo[1] : s.halo[3];
    }
    unsigned km = 0;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      if (k < cnt) {
        const bool keep = !(vh[k] == SENT && vl[k] == SENT) &&
                          (!has_prev || vh[k] != ph || vl[k] != pl);
        km |= (unsigned)keep << k;
        has_prev = true;
        ph = vh[k];
        pl = vl[k];
      }
    }
    int rank, nkeep;
    Scan(s.scan_tmp).ExclusiveSum(__popc(km), rank, nkeep);
    if (tid == 0) publish(desc, t, ST_AGG, nkeep);

    // survivors at their ranks in the tile, before the offset is known
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      if ((km >> k) & 1) {
        s.hi[rank] = vh[k];
        s.lo[rank] = vl[k];
        s.f[rank] = (uint8_t)((fm >> k) & 1);
        ++rank;
      }
    }
    if (tid < 32) {
      const long long excl = look_back(desc, t, nkeep, tid);
      if (tid == 0) {
        s.off = excl;
        if (t == ntiles - 1) hdr[H_NLIVE] = excl + nkeep;
      }
    }
    __syncthreads();

    // the tile's survivors, contiguous in the output
    const long long off = s.off;
    const long long room = out_cap - off;
    const int m = room <= 0 ? 0 : (room < nkeep ? (int)room : nkeep);
    {
      const int odd = (int)((((uintptr_t)(ohi + off)) >> 3) & 1);
      if (odd && tid == 0 && m > 0) ohi[off] = s.hi[0];
      for (int x = odd + 2 * tid; x < m; x += 2 * NT) {
        if (x + 1 < m)
          *(ulonglong2*)(ohi + off + x) = make_ulonglong2(s.hi[x], s.hi[x + 1]);
        else
          ohi[off + x] = s.hi[x];
      }
    }
    {
      const int odd = (int)((((uintptr_t)(olo + off)) >> 3) & 1);
      if (odd && tid == 0 && m > 0) olo[off] = s.lo[0];
      for (int x = odd + 2 * tid; x < m; x += 2 * NT) {
        if (x + 1 < m)
          *(ulonglong2*)(olo + off + x) = make_ulonglong2(s.lo[x], s.lo[x + 1]);
        else
          olo[off + x] = s.lo[x];
      }
    }
    {
      uint8_t* dst = of + off;
      const int mis = (int)(((uintptr_t)dst) & 3);
      int head = mis ? 4 - mis : 0;
      if (head > m) head = m;
      if (tid < head) dst[tid] = s.f[tid];
      for (int x = head + 4 * tid; x < m; x += 4 * NT) {
        if (x + 3 < m) {
          *(uint32_t*)(dst + x) =
              (uint32_t)s.f[x] | ((uint32_t)s.f[x + 1] << 8) |
              ((uint32_t)s.f[x + 2] << 16) | ((uint32_t)s.f[x + 3] << 24);
        } else {
          for (int y = x; y < m; ++y) dst[y] = s.f[y];
        }
      }
    }
    __syncthreads();  // the arrays and s.tile are reused by the next tile
  }
}

__global__ void k_fill_tail(uint64_t* ohi, uint64_t* olo, uint8_t* of,
                            long long out_cap, const long long* hdr) {
  const long long n_live = hdr[H_NLIVE];
  long long start = n_live < out_cap ? n_live : out_cap;
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

// Scratch words (int64) the caller provides for n = na + nb input entries.
long long merge128_scratch_words(long long n) {
  long long max_tiles = (n + TILE - 1) / TILE;
  return HDR + max_tiles + max_tiles + 1;
}

// The scratch word that holds n_live after the launch.
int merge128_nlive_word() { return H_NLIVE; }

int merge128_launch(const void* ahi, const void* alo, const void* af,
                    long long na, const void* bhi, const void* blo,
                    const void* bf, long long nb, void* ohi, void* olo,
                    void* of, long long out_cap, void* scratch,
                    void* stream) {
  // blocks of k_merge the current device holds at once: the look-back
  // relies on every launched block being resident.  Asked on every launch
  // (the queries are cheap), so a second device gets its own answer.
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // more than 48 KB of shared memory has to be asked for
  cudaError_t e = cudaFuncSetAttribute(
      k_merge, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(Shared));
  if (e != cudaSuccess) return (int)e;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k_merge, NT,
                                                sizeof(Shared));
  if (sms <= 0 || per_sm <= 0) return (int)cudaErrorLaunchFailure;
  const long long grid_max = (long long)sms * per_sm;
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
  long long max_tiles = (na + nb + TILE - 1) / TILE;
  long long* hdr = (long long*)scratch;
  long long* co = hdr + HDR + max_tiles;
  e = cudaMemsetAsync(hdr, 0, sizeof(long long) * (HDR + max_tiles), st);
  if (e != cudaSuccess) return (int)e;
  int pb = 128;
  k_partition<<<(unsigned)((max_tiles + 1 + pb - 1) / pb), pb, 0, st>>>(
      g, max_tiles, hdr, co);
  if (max_tiles > 0) {
    long long blocks = max_tiles < grid_max ? max_tiles : grid_max;
    k_merge<<<(unsigned)blocks, NT, sizeof(Shared), st>>>(
        g, hdr, co, (uint64_t*)ohi, (uint64_t*)olo, (uint8_t*)of, out_cap);
  }
  if (out_cap > 0) {
    long long blocks = (out_cap + 255) / 256;
    if (blocks > 4096) blocks = 4096;
    k_fill_tail<<<(unsigned)blocks, 256, 0, st>>>(
        (uint64_t*)ohi, (uint64_t*)olo, (uint8_t*)of, out_cap,
        (const long long*)hdr);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
