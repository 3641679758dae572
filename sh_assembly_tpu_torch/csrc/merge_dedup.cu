// Streaming merge-dedup-compact of the counting store (kernel K1).
//
// Replaces the TPU kernel sh_assembly_tpu/ops/merge_pallas.py:merge_planes.
// It folds the key-sorted main store A (n_main live packed entries,
//   packed = key << KSHIFT | traveled << CBITS | count, count >= 1)
// and the key-sorted buffer B (count field 0 = one buffered occurrence,
// all-ones sentinels at its tail) into one sorted store with one entry per
// key: effective counts (count + (count == 0)) summed over the key's run
// and saturated at CAP, the traveled bit of the run's last element (the
// max-traveled copy sorts last, so that is the OR over the run), runs that
// total 1 dropped when drop_singletons is set.  n_live may exceed the
// output capacity: entries beyond it are not written, and the caller
// raises on the overflow.  Behind the live entries the output is sentinel
// up to out_dirty; the caller promises that it already is from there on.
//
// What bounds it on an H100: bytes.  The work per element is a handful of
// integer ops, so the floor is reading A and the live part of B once and
// writing the live result once (8 B per word each way).
// Design: one pass over the inputs, three kernels.
//   1. k_partition   finds B's first sentinel, so its tail is never merged,
//                    and the merge-path co-rank of every tile boundary
//                    (a tile is TILE merged positions), all at once.
//   2. k_merge       persistent blocks take tile ids from an atomic
//                    counter.  A tile copies its A and B ranges to shared
//                    memory as asynchronous 16-byte copies, and each thread
//                    merges ITEMS consecutive positions into registers
//                    (ITEMS is odd, so the threads' starting points spread
//                    over the banks) and works out each element's facts
//                    once, as bit masks: run head, run end, singleton.
//                    One block scan gives the segmented (run-restarting)
//                    sums and the survivor ranks, and the survivors are
//                    compacted in shared memory before the carry is known:
//                    only the run that entered the tile open needs it, and
//                    its end is survivor 0.  Across tiles a decoupled
//                    look-back carries the open run's sum and the output
//                    offset: a tile publishes its aggregate in one 16-byte
//                    word with a status in both halves, a warp walks back
//                    over its predecessors, 32 at a time, until it meets
//                    an inclusive prefix, and publishes its own.  A reader
//                    takes a word only when both halves carry the same
//                    status, so a torn read is read again; tile ids come
//                    from the counter, so every tile waited for belongs to
//                    a block that is already running.  Survivors leave
//                    with 16-byte stores.  The last tile's inclusive prefix
//                    is n_live; n_dropped is summed with one atomic a tile.
//                    Blocks waiting in the look-back cost about a tenth
//                    of the kernel's time (1.61 ms with the wait cut out
//                    against 1.81 ms, at 100 M + 2^27 words on an H100
//                    80GB HBM3 at 700 W), and less the fewer tiles there
//                    are, so tiles are as large as registers allow (63 KB
//                    of dynamic shared memory, three blocks an SM).
//   3. k_fill_tail   sentinels over [min(n_live, capacity), out_dirty).
// The survivor decision needs no carry: a run that crosses a tile boundary
// has at least two elements, so it totals >= 2 and is never a singleton.
//
// Plain C interface for ctypes; launches on the caller's stream, allocates
// nothing (the wrapper hands in scratch, which the launch zeroes on the
// stream) and returns cudaGetLastError().

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int NT = 256;               // threads per block
constexpr int ITEMS = 27;             // merged elements per thread (odd)
constexpr int TILE = NT * ITEMS;      // merged elements per tile
constexpr int MINB = 3;               // blocks per SM the compiler must fit
static_assert(ITEMS <= 32, "an element's facts are bits of one 32-bit mask");
static_assert(TILE < (1 << 16), "a tile's counts are 16-bit fields");
constexpr uint64_t SENT = ~0ull;

// scratch layout, in 8-byte words: HDR header words, DESC words for each
// tile (both zeroed by the launch), then the co-ranks
constexpr int HDR = 8;                // nb_live, n, ntiles, tile counter
constexpr int DESC = 2;               // status|f|v, status|keep
constexpr unsigned long long ST_AGG = 1, ST_INC = 2;
constexpr int ST_SHIFT = 62, F_SHIFT = 61;
constexpr unsigned long long LOW = (1ull << F_SHIFT) - 1;

// What a tile (or a prefix of tiles) hands to its successors.
struct State {
  unsigned long long v;               // effective counts since the last head
  int f;                              // a run head was seen
  long long keep;                     // survivors
};

__device__ __forceinline__ State combine(const State& x, const State& y) {
  State r;
  r.f = x.f | y.f;
  r.v = y.f ? y.v : x.v + y.v;
  r.keep = x.keep + y.keep;
  return r;
}

// The block-scan element, 16 bytes: v and f as in State; kd counts the
// survivors in its low and the dropped singletons in its high 16 bits (a
// tile has at most TILE of either).
struct Part {
  unsigned long long v;
  unsigned f, kd;
};

struct PartOp {
  __device__ __forceinline__ Part operator()(const Part& x,
                                             const Part& y) const {
    Part r;
    r.f = x.f | y.f;
    r.v = y.f ? y.v : x.v + y.v;
    r.kd = x.kd + y.kd;
    return r;
  }
};

struct Geo {
  const uint64_t* a;
  long long na;
  const uint64_t* b;
  long long nb;
  int kshift;
  int cbits;
  unsigned long long cap;
  int drop;
};

// Number of A elements among the first d merged elements.  An A element
// precedes a B element iff it is strictly smaller (equal words are equal
// entries, so the tie rule does not change the output).
__device__ __forceinline__ long long corank(long long d, const uint64_t* a,
                                            long long na, const uint64_t* b,
                                            long long nb) {
  long long lo = d - nb > 0 ? d - nb : 0;
  long long hi = d < na ? d : na;
  while (lo < hi) {
    long long i = (lo + hi) >> 1;
    if (a[i] < b[d - i - 1]) lo = i + 1; else hi = i;
  }
  return lo;
}

// One thread per tile boundary t: B's live length (its first sentinel;
// every thread walks the same few cache lines) and the co-rank of t * TILE.
__global__ void k_partition(Geo g, long long max_tiles, long long* hdr,
                            long long* co, long long* meta) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t > max_tiles) return;
  long long lo = 0, hi = g.nb;
  while (lo < hi) {
    long long mid = (lo + hi) >> 1;
    if (g.b[mid] != SENT) lo = mid + 1; else hi = mid;
  }
  const long long nb_live = lo;
  const long long n = g.na + nb_live;
  const long long ntiles = (n + TILE - 1) / TILE;
  if (t == 0) {
    hdr[0] = nb_live;
    hdr[1] = n;
    hdr[2] = ntiles;
    meta[0] = meta[1] = 0;  // the tiles set n_live and add up n_dropped
  }
  if (t > ntiles) return;
  const long long d = t * TILE < n ? t * TILE : n;
  co[t] = corank(d, g.a, g.na, g.b, nb_live);
}

// Start copying src[start, start + count) into the 16-byte aligned shared
// region reg, as asynchronous 16-byte copies where src allows, and return
// where src[start] lands: reg, or reg + 1 when src + start is not a
// multiple of 16 (the word before the range is then copied too).  reg
// needs count + 1 words.  The caller waits with __pipeline_wait_prior(0)
// and a barrier.
__device__ __forceinline__ const uint64_t* load_range(uint64_t* reg,
                                                      const uint64_t* src,
                                                      long long start,
                                                      int count) {
  const int odd = (int)((((uintptr_t)(src + start)) >> 3) & 1);
  const bool vec = (((uintptr_t)src) & 15) == 0;  // then start - odd >= 0
  const long long g0 = start - odd;
  const int end = odd + count;
  for (int x = 2 * threadIdx.x; x < end; x += 2 * NT) {
    if (vec && x + 1 < end) {
      __pipeline_memcpy_async(reg + x, src + g0 + x, 16);
    } else {
      if (x >= odd) reg[x] = src[g0 + x];
      if (x + 1 < end) reg[x + 1] = src[g0 + x + 1];
    }
  }
  __pipeline_commit();
  return reg + odd;
}

struct Smem {
  __align__(16) uint64_t w[TILE + 8];  // the tile's A and B ranges, then
                                       // its compacted survivors
  uint64_t first[NT], last[NT];        // each thread's end elements
  uint64_t halo[4];                    // A, B before the tile; A, B after
  long long tile;
  unsigned long long open_run;         // the run that entered the tile open:
                                       // its total inside the tile, or NONE
  long long off;
};
constexpr unsigned long long NONE = ~0ull;

using Scan = cub::BlockScan<Part, NT>;
struct Shared {                        // k_merge's dynamic shared memory
  Smem s;
  Scan::TempStorage scan_tmp;
};

// A tile's descriptor is one 16-byte word, read and written whole; both
// halves carry the status, so a read that caught two different writes
// shows it.
__device__ __forceinline__ void publish(unsigned long long* desc, long long t,
                                        unsigned long long status,
                                        const State& s) {
  const unsigned long long x =
      (status << ST_SHIFT) | ((unsigned long long)s.f << F_SHIFT) | s.v;
  const unsigned long long y =
      (status << ST_SHIFT) | (unsigned long long)s.keep;
  asm volatile("st.relaxed.gpu.global.v2.u64 [%0], {%1, %2};" ::"l"(
                   desc + t * DESC),
               "l"(x), "l"(y)
               : "memory");
}

// Spin until tile p's descriptor holds a status; returns it with the state.
__device__ __forceinline__ unsigned long long wait_for(
    const unsigned long long* desc, long long p, State& s) {
  unsigned long long x, y;
  int tries = 0;
  while (true) {
    asm volatile("ld.relaxed.gpu.global.v2.u64 {%0, %1}, [%2];"
                 : "=l"(x), "=l"(y)
                 : "l"(desc + p * DESC)
                 : "memory");
    if ((x >> ST_SHIFT) != 0 && (x >> ST_SHIFT) == (y >> ST_SHIFT)) break;
    __nanosleep(20);
    if (++tries > (1 << 24)) __trap();  // a lost tile: fail, do not hang
  }
  s.v = x & LOW;
  s.f = (int)((x >> F_SHIFT) & 1);
  s.keep = (long long)(y & ((1ull << ST_SHIFT) - 1));
  return x >> ST_SHIFT;
}

// Walk back from tile t to the nearest inclusive prefix, publish t's own
// and return the exclusive prefix (valid in lane 0).  Run by one whole
// warp, after t's aggregate is published.
__device__ __noinline__ State look_back(unsigned long long* desc, long long t,
                                        const State& agg, int lane) {
  State excl{0ull, 0, 0};
  for (long long base = t - 1;; base -= 32) {
    const long long p = base - lane;  // lane 0 reads the nearest tile
    State val{0ull, 0, 0};
    unsigned long long st = ST_INC;   // before tile 0: an empty prefix
    if (p >= 0) st = wait_for(desc, p, val);
    const unsigned incl = __ballot_sync(0xFFFFFFFFu, st == ST_INC);
    const int limit = incl ? __ffs(incl) - 1 : 31;
    // ordered reduction of lanes limit..0 into lane 0 (higher lanes hold
    // earlier tiles, the left operands)
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      State other;
      other.v = __shfl_down_sync(0xFFFFFFFFu, val.v, o);
      other.f = __shfl_down_sync(0xFFFFFFFFu, val.f, o);
      other.keep = __shfl_down_sync(0xFFFFFFFFu, val.keep, o);
      if (lane + o <= limit) val = combine(other, val);
    }
    excl = combine(val, excl);
    if (incl) break;
  }
  if (lane == 0) publish(desc, t, ST_INC, combine(excl, agg));
  return excl;
}

__global__ void __launch_bounds__(NT, MINB) k_merge(
    Geo g, long long* hdr, const long long* __restrict__ co,
    uint64_t* __restrict__ out, long long out_cap, long long* meta) {
  extern __shared__ __align__(16) unsigned char shared_raw[];
  Shared& sh = *reinterpret_cast<Shared*>(shared_raw);
  Smem& s = sh.s;
  Scan::TempStorage& scan_tmp = sh.scan_tmp;
  const int tid = threadIdx.x;
  const long long nb_live = hdr[0], n = hdr[1], ntiles = hdr[2];
  const uint64_t cmask = (1ull << g.cbits) - 1;
  const uint64_t payload_mask = (1ull << g.kshift) - 1;

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
    const int la = (int)(i1 - i0), lb = (int)(j1 - j0);
    const int len = la + lb;
    const uint64_t* sa = load_range(s.w, g.a, i0, la);
    const uint64_t* sb = load_range(s.w + ((la + 3) & ~1), g.b, j0, lb);
    // the merged element before the tile is the larger of the last A and
    // last B consumed; the one after it the smaller of the next A and B
    if (tid == 0) s.halo[0] = i0 > 0 ? g.a[i0 - 1] : 0;
    if (tid == 1) s.halo[1] = j0 > 0 ? g.b[j0 - 1] : 0;
    if (tid == 2) s.halo[2] = i1 < g.na ? g.a[i1] : SENT;
    if (tid == 3) s.halo[3] = j1 < nb_live ? g.b[j1] : SENT;
    if (tid == 4) s.open_run = NONE;
    __pipeline_wait_prior(0);
    __syncthreads();

    // this thread's ITEMS merged positions, by merge path, into registers
    int d = tid * ITEMS;
    if (d > len) d = len;
    const int cnt = len - d < ITEMS ? len - d : ITEMS;
    int lo = d - lb > 0 ? d - lb : 0;
    int hi = d < la ? d : la;
    while (lo < hi) {
      int i = (lo + hi) >> 1;
      if (sa[i] < sb[d - i - 1]) lo = i + 1; else hi = i;
    }
    int i = lo, j = d - lo;
    // an exhausted side reads as all-ones, above every real entry
    uint64_t ea = i < la ? sa[i] : SENT;
    uint64_t eb = j < lb ? sb[j] : SENT;
    uint64_t v[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      if (ea < eb) {
        v[k] = ea;
        ++i;
        ea = i < la ? sa[i] : SENT;
      } else {
        v[k] = eb;
        ++j;
        eb = j < lb ? sb[j] : SENT;
      }
    }
    s.first[tid] = v[0];
    s.last[tid] = v[ITEMS - 1];
    __syncthreads();  // also: every thread is done reading s.w

    // the keys around this thread's elements
    bool has_prev, has_next;
    uint64_t pkey, nkey;
    if (tid > 0) {  // cnt > 0 implies the thread before is full
      has_prev = true;
      pkey = s.last[tid - 1] >> g.kshift;
    } else {
      has_prev = d0 > 0;
      uint64_t p = s.halo[0] > s.halo[1] ? s.halo[0] : s.halo[1];
      pkey = p >> g.kshift;
    }
    if (cnt == ITEMS && d + ITEMS < len) {
      has_next = true;
      nkey = s.first[tid + 1] >> g.kshift;
    } else {
      has_next = d1 < n;
      uint64_t q = s.halo[2] < s.halo[3] ? s.halo[2] : s.halo[3];
      nkey = q >> g.kshift;
    }

    // each element's facts, once: bit k of headm / endm / singlem
    unsigned headm = 0, endm = 0, singlem = 0;
    Part acc{0ull, 0u, 0u};
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      if (k < cnt) {
        const uint64_t key = v[k] >> g.kshift;
        const bool head = !has_prev || key != pkey;
        bool end;
        if (k + 1 < cnt) end = (v[k + 1 < ITEMS ? k + 1 : k] >> g.kshift) != key;
        else end = !has_next || nkey != key;
        const unsigned long long c = v[k] & cmask;
        const unsigned long long eff = c == 0 ? 1ull : c;
        if (head) { acc.f = 1u; acc.v = eff; } else { acc.v += eff; }
        // a run totals 1 iff it is one element of effective count 1
        const bool single = g.drop && head && end && eff == 1;
        if (end) acc.kd += single ? (1u << 16) : 1u;
        headm |= (unsigned)head << k;
        endm |= (unsigned)end << k;
        singlem |= (unsigned)single << k;
        has_prev = true;
        pkey = key;
      }
    }
    Part pre, agg;
    Scan(scan_tmp).ExclusiveScan(acc, pre, Part{0ull, 0u, 0u}, PartOp(), agg);
    const int nkeep = (int)(agg.kd & 0xFFFFu);

    const State a{agg.v, (int)agg.f, (long long)nkeep};
    unsigned long long* desc = (unsigned long long*)(hdr + HDR);
    if (tid == 0) {
      publish(desc, t, ST_AGG, a);
      if (agg.kd >> 16)
        atomicAdd((unsigned long long*)(meta + 1),
                  (unsigned long long)(agg.kd >> 16));
    }

    // run totals and survivors at their ranks in the tile, before the
    // carry is known: only the run that entered the tile open can need
    // it, and that run's end, if it is in the tile, is survivor 0
    unsigned long long run = pre.v;
    bool open = !pre.f;
    int rank = (int)(pre.kd & 0xFFFFu);
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      if (k < cnt) {
        const unsigned long long c = v[k] & cmask;
        const unsigned long long eff = c == 0 ? 1ull : c;
        if ((headm >> k) & 1) { run = eff; open = false; } else { run += eff; }
        if (((endm >> k) & 1) && !((singlem >> k) & 1)) {
          if (open) s.open_run = run;
          const unsigned long long total = run < g.cap ? run : g.cap;
          const uint64_t trav = (v[k] >> g.cbits) & 1ull;
          s.w[rank++] = (v[k] & ~payload_mask) | (trav << g.cbits) | total;
        }
      }
    }
    __syncthreads();

    if (tid < 32) {
      State excl = look_back(desc, t, a, tid);
      if (tid == 0) {
        s.off = excl.keep;
        if (s.open_run != NONE) {
          unsigned long long total = s.open_run + excl.v;
          if (total > g.cap) total = g.cap;
          s.w[0] = (s.w[0] & ~cmask) | total;
        }
        if (t == ntiles - 1) meta[0] = excl.keep + a.keep;
      }
    }
    __syncthreads();

    // the tile's survivors, contiguous in the output
    const long long off = s.off;
    long long room = out_cap - off;
    const int m = room <= 0 ? 0 : (room < nkeep ? (int)room : nkeep);
    const int odd = (int)((((uintptr_t)(out + off)) >> 3) & 1);
    if ((((uintptr_t)out) & 15) == 0) {
      if (odd && tid == 0 && m > 0) out[off] = s.w[0];
      for (int x = odd + 2 * tid; x < m; x += 2 * NT) {
        if (x + 1 < m)
          *(ulonglong2*)(out + off + x) = make_ulonglong2(s.w[x], s.w[x + 1]);
        else
          out[off + x] = s.w[x];
      }
    } else {
      for (int x = tid; x < m; x += NT) out[off + x] = s.w[x];
    }
    __syncthreads();  // s.w and s.tile are reused by the next tile
  }
}

__global__ void k_fill_tail(uint64_t* out, long long out_cap, long long end,
                            const long long* meta) {
  long long start = meta[0] < out_cap ? meta[0] : out_cap;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = start + (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < end; i += stride)
    out[i] = SENT;
}

}  // namespace

extern "C" {

// Scratch words (int64) the caller provides for n = na + nb input words.
long long merge_dedup_scratch_words(long long n) {
  long long max_tiles = (n + TILE - 1) / TILE;
  return HDR + DESC * max_tiles + max_tiles + 1;
}

// out[out_dirty:] must already be all sentinel; out_dirty = out_cap makes
// no assumption.
int merge_dedup_launch(const void* a, long long na, const void* b,
                       long long nb, void* out, long long out_cap,
                       long long out_dirty, void* scratch, void* meta,
                       int key_bits, int drop_singletons, void* stream) {
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
  g.a = (const uint64_t*)a;
  g.na = na;
  g.b = (const uint64_t*)b;
  g.nb = nb;
  g.kshift = 64 - key_bits;
  g.cbits = (g.kshift < 32 ? g.kshift : 32) - 1;
  unsigned long long cap = (1ull << g.cbits) - 2;
  g.cap = cap < (1ull << 30) ? cap : (1ull << 30);
  g.drop = drop_singletons;
  long long max_tiles = (na + nb + TILE - 1) / TILE;
  long long* hdr = (long long*)scratch;
  long long* co = hdr + HDR + DESC * max_tiles;
  e = cudaMemsetAsync(
      hdr, 0, sizeof(long long) * (HDR + DESC * max_tiles), st);
  if (e != cudaSuccess) return (int)e;
  int pb = 128;
  k_partition<<<(unsigned)((max_tiles + 1 + pb - 1) / pb), pb, 0, st>>>(
      g, max_tiles, hdr, co, (long long*)meta);
  if (max_tiles > 0) {
    long long blocks = max_tiles < grid_max ? max_tiles : grid_max;
    k_merge<<<(unsigned)blocks, NT, sizeof(Shared), st>>>(
        g, hdr, co, (uint64_t*)out, out_cap, (long long*)meta);
  }
  if (out_dirty > 0) {
    long long blocks = (out_dirty + 255) / 256;
    if (blocks > 4096) blocks = 4096;
    k_fill_tail<<<(unsigned)blocks, 256, 0, st>>>(
        (uint64_t*)out, out_cap, out_dirty, (const long long*)meta);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
