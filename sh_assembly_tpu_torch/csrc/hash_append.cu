// Hash and append a stack of read batches to the counting buffer: the
// counting stage's device step (kernel K5).
//
// Replaces the JAX package's fused counting scan,
// sh_assembly_tpu/models/counter.py:append_scan_packed (and append_scan,
// count_batch): an XLA-fused lax.scan over S batches that unpacks the
// 2-bit transport, computes the canonical ntHash of every window, masks it
// to key_bits and appends it to the log buffer.  It reaches no
// pl.pallas_call; XLA fused it on the TPU, and on the card it is this
// kernel.  The mesh counter's hash (parallel/sharded.py) launches it too.
//
// What one launch computes, for R = S * B rows of L bases and W = L - k + 1
// windows a row: out[row * W + i] for every row and window, in row-major
// then window order (the order S consecutive single-batch appends write),
//   -1                                    if i + k > length[row]
//   min(fh, rh) & (2^key_bits - 1)        otherwise, with
//   fh = XOR_{t<k} rol(seed(c[i+t]), k-1-t),  rh = XOR_{t<k} rol(cseed(c[i+t]), t)
// (unsigned min).  N and pad bases (an nmask bit set, or a code >= 4) have
// seed 0: they are hashed, not skipped.  The count of valid windows, sum
// over rows of clamp(length - k + 1, 0, W), is added to *nelts.
//
// How: the prefix-XOR identity of ops/nthash.py.  With a_j = rol(seed(c_j),
// -j mod 64), b_j = rol(cseed(c_j), j mod 64) for the absolute column j of
// a row, and P, Q their exclusive prefix XORs,
//   fh(i) = rol(P[i+k] ^ P[i], (k-1+i) mod 64),  rh(i) = rol(Q[i+k] ^ Q[i], -i mod 64),
// bit for bit (XOR is exact).  A block takes a tile: a group of whole rows,
// or a segment of a row longer than a tile (segments overlap by k - 1
// bases and rotate by their absolute columns).  Either way the tile's
// bases are one contiguous run of the input, which the block
//   1. stages in shared memory as codes, N and pad as code 4;
//   2. scans as one sequence: each thread computes (a, b) of a run of 16
//      bases into their slots and XORs them, a shuffle scan across the warp
//      and the warps' totals give each run its start, and the thread turns
//      its slots into P and Q in place (16 B a base, one pad slot every 16
//      so that the runs' accesses fall in distinct banks).  The rows of a
//      tile need no reset: P[i+k] ^ P[i] of a window inside a row cancels
//      every row before it;
//   3. writes one key a thread, thread = window in flat (row, window)
//      order, so every warp's store is one contiguous 256-byte run: two
//      16-byte shared loads, two rotations, an unsigned min and a mask a
//      key.  A thread steps its (row, window) by the block's stride, so no
//      key needs a division.
// What bounds it on an H100: bytes.  Each key is 8 bytes written against a
// quarter byte of packed bases and an eighth of a byte of N mask read, so
// the floor is writing the keys once.  The scan is paid once a base (about
// 1.4 bases a key in rows of 160), not k shared-memory lookups a key as in
// the first version of this kernel, and a rotation is two funnel shifts
// (no shift by 64 at a rotation by 0).  A tile of 4096 bases takes about
// 72 KB of shared memory, above the 48 KB default: the launch queries the
// device's opt-in limit and sets the kernel's dynamic size on every launch
// (nothing is cached between launches), and three blocks fit an SM.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;              // threads a block
constexpr int MIN_BLOCKS = 3;        // blocks an SM (the registers allowed)
constexpr int RUN = 16;              // bases a thread scans (one uint4)
constexpr int TILE = NT * RUN;       // bases a block stages at most
constexpr int MAX_ROWS = NT;         // rows a tile at most (one a thread)
constexpr int N_CODE = 4;            // N and pad: seed 0
constexpr size_t DEFAULT_SMEM = 48 * 1024;

typedef unsigned long long u64;

// The published ntHash seeds (A, C, G, T) and their complements' (T, G, C,
// A), as utils/nthash.py has them.
__constant__ u64 SEEDS[4] = {0x3C8BFBB395C60474ull, 0x3193C18562A02B4Cull,
                             0x20323ED082572324ull, 0x295549F54BE24456ull};
__constant__ u64 CSEEDS[4] = {0x295549F54BE24456ull, 0x20323ED082572324ull,
                              0x3193C18562A02B4Cull, 0x3C8BFBB395C60474ull};

// x rotated left by s in [0, 64): a swap of the halves for s >= 32, then
// two funnel shifts by s mod 32 (a funnel shift by 0 returns its high word).
__device__ __forceinline__ u64 rol(u64 x, unsigned s) {
  unsigned lo = (unsigned)x, hi = (unsigned)(x >> 32);
  if (s & 32) {
    const unsigned t = lo;
    lo = hi;
    hi = t;
  }
  return ((u64)__funnelshift_l(lo, hi, s) << 32) | __funnelshift_l(hi, lo, s);
}

// Slot of prefix entry t: one pad slot after every RUN entries.
__host__ __device__ __forceinline__ int pidx(int t) { return t + t / RUN; }

// How a launch is cut into tiles.
struct Plan {
  int rpb;         // rows a tile (1 for segments)
  int sw;          // windows a segment (W for whole rows)
  int segs;        // segments a row (1 for whole rows)
  long long grid;  // blocks
  size_t smem;     // dynamic shared memory of the largest tile
};

Plan make_plan(long long rows, int L, int k) {
  const int W = L - k + 1;
  Plan p;
  int n_t;  // bases of the largest tile
  if (L <= TILE) {
    p.rpb = TILE / L < MAX_ROWS ? TILE / L : MAX_ROWS;
    p.sw = W;
    p.segs = 1;
    p.grid = (rows + p.rpb - 1) / p.rpb;
    n_t = (int)(rows < p.rpb ? rows : p.rpb) * L;
  } else {
    p.rpb = 1;
    p.sw = (TILE - (k - 1)) & ~7;  // segments start at multiples of 8 bases
    p.segs = (W + p.sw - 1) / p.sw;
    p.grid = rows * p.segs;
    n_t = TILE;
  }
  // prefix pairs, then the codes (a whole uint4 a thread), then lengths
  p.smem = sizeof(ulonglong2) * (pidx(n_t) + 1) + ((n_t + 15) & ~15) +
           sizeof(int) * p.rpb;
  return p;
}

__global__ void __launch_bounds__(NT, MIN_BLOCKS) k_hash_append(
    const uint8_t* __restrict__ packed, const uint8_t* __restrict__ nmask,
    const uint8_t* __restrict__ codes, const int* __restrict__ lengths,
    long long rows, int L, int k, u64 mask, int rpb, int sw, int segs,
    u64* __restrict__ out, u64* __restrict__ nelts) {
  __shared__ ulonglong2 s_seed[8];        // (seed, cseed) by code
  __shared__ ulonglong2 s_warp[NT / 32];  // the warps' (a, b) totals
  extern __shared__ __align__(16) uint8_t smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int W = L - k + 1;
  // the tile: windows [i0, i0 + nw) of rows [row0, row0 + nr), staged
  // bases [i0, i0 + ls) of each
  long long row0;
  int nr, i0, nw;
  if (segs == 1) {
    row0 = (long long)blockIdx.x * rpb;
    nr = (int)min((long long)rpb, rows - row0);
    i0 = 0;
    nw = W;
  } else {
    row0 = blockIdx.x / segs;
    i0 = (int)(blockIdx.x - row0 * segs) * sw;
    nr = 1;
    nw = min(sw, W - i0);
  }
  const int ls = nw + k - 1;  // L for whole rows
  const int n_t = nr * ls;
  const int n_c = (n_t + 15) & ~15;
  ulonglong2* pq = reinterpret_cast<ulonglong2*>(smem);
  uint8_t* s_codes = smem + sizeof(ulonglong2) * (pidx(n_t) + 1);
  int* s_len = reinterpret_cast<int*>(s_codes + n_c);

  // 1. stage: the tile's bases are one run of the input from g0
  if (tid < 8)
    s_seed[tid] = tid < N_CODE ? make_ulonglong2(SEEDS[tid], CSEEDS[tid])
                               : make_ulonglong2(0ull, 0ull);
  // (fixed trip counts, so that every load of a thread is in flight at
  // once)
  const long long g0 = row0 * L + i0;
  if (codes != nullptr) {
    const uint8_t* src = codes + g0;
#pragma unroll
    for (int m = 0; m < RUN; ++m) {
      const int t = m * NT + tid;
      if (t < n_c) {
        const uint8_t c = t < n_t ? src[t] : N_CODE;
        s_codes[t] = c < N_CODE ? c : N_CODE;
      }
    }
  } else {
    // L % 8 == 0 and g0 % 8 == 0 (segments start at multiples of 8): eight
    // bases a thread from two packed bytes and one mask byte
    const uint16_t* pk = reinterpret_cast<const uint16_t*>(packed + g0 / 4);
    const uint8_t* nm = nmask + g0 / 8;
#pragma unroll
    for (int m = 0; m < RUN / 8; ++m) {
      const int e = m * NT + tid, t = 8 * e;
      if (t < n_c) {
        u64 eight = 0x0404040404040404ull;
        if (t < n_t) {
          const unsigned p = pk[e], bad = nm[e];
          eight = 0;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const u64 c = t + j >= n_t || (bad >> j) & 1 ? N_CODE
                                                         : (p >> (2 * j)) & 3;
            eight |= c << (8 * j);
          }
        }
        *reinterpret_cast<u64*>(s_codes + t) = eight;
      }
    }
  }
  unsigned v = 0;
  if (tid < nr) {
    const int len = lengths[row0 + tid];
    s_len[tid] = len;
    v = (unsigned)max(0, min(len - k + 1 - i0, nw));
  }
  v = __reduce_add_sync(0xffffffffu, v);
  if (lane == 0 && v) atomicAdd(nelts, (u64)v);
  __syncthreads();

  // 2. scan: this thread's run [t0, t0 + RUN), its columns from c0; the
  // run's (a, b) go to its slots, then their prefixes over them
  const int t0 = tid * RUN;
  uint4 raw = make_uint4(0x04040404u, 0x04040404u, 0x04040404u, 0x04040404u);
  if (t0 < n_t) raw = *reinterpret_cast<const uint4*>(s_codes + t0);
  const unsigned word[4] = {raw.x, raw.y, raw.z, raw.w};
  ulonglong2* run = pq + pidx(t0);
  u64 xa = 0, xb = 0;
  {
    int c = t0 < n_t ? t0 % ls : 0;
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
      const ulonglong2 sd = s_seed[(word[j >> 2] >> (8 * (j & 3))) & 0xFF];
      const unsigned col = (unsigned)(i0 + c);
      const u64 a = rol(sd.x, (0u - col) & 63), b = rol(sd.y, col & 63);
      if (t0 + j < n_t) run[j] = make_ulonglong2(a, b);
      xa ^= a;
      xb ^= b;
      c = c + 1 == ls ? 0 : c + 1;
    }
  }
  u64 ia = xa, ib = xb;  // inclusive scan of the runs across the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const u64 ya = __shfl_up_sync(0xffffffffu, ia, d);
    const u64 yb = __shfl_up_sync(0xffffffffu, ib, d);
    if (lane >= d) {
      ia ^= ya;
      ib ^= yb;
    }
  }
  if (lane == 31) s_warp[warp] = make_ulonglong2(ia, ib);
  __syncthreads();
  u64 pa = ia ^ xa, pb = ib ^ xb;  // the run's start
  for (int w = 0; w < warp; ++w) {
    pa ^= s_warp[w].x;
    pb ^= s_warp[w].y;
  }
  if (t0 <= n_t) {
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
      if (t0 + j <= n_t) {  // P[n_t] closes the tile
        const ulonglong2 v =
            t0 + j < n_t ? run[j] : make_ulonglong2(0ull, 0ull);
        run[j] = make_ulonglong2(pa, pb);
        pa ^= v.x;
        pb ^= v.y;
      }
    }
    if (n_t == TILE && tid == NT - 1) pq[pidx(TILE)] = make_ulonglong2(pa, pb);
  }
  __syncthreads();

  // 3. keys: local key q = r * nw + i, stepped by NT = dr rows + di windows
  const int n_keys = nr * nw;
  const int dr = NT / nw, di = NT - dr * nw;
  int r = tid / nw, i = tid - r * nw;
  u64* dst = out + row0 * W + i0;
  for (int q = tid; q < n_keys; q += NT) {
    const int a = r * ls + i;
    const ulonglong2 lo = pq[pidx(a)], hi = pq[pidx(a + k)];
    const unsigned col = (unsigned)(i0 + i);
    u64 key = ~0ull;
    if ((int)col + k <= s_len[r]) {
      const u64 fh = rol(hi.x ^ lo.x, (col + k - 1) & 63);
      const u64 rh = rol(hi.y ^ lo.y, (0u - col) & 63);
      key = (fh < rh ? fh : rh) & mask;
    }
    dst[q] = key;
    r += dr;
    i += di;
    if (i >= nw) {
      i -= nw;
      ++r;
    }
  }
}

}  // namespace

extern "C" {

// The tile plan of a launch and what the built kernel uses, into out[9]:
// rows a tile, windows a segment, segments a row, blocks, dynamic shared
// bytes, static shared bytes, registers a thread, local (spill) bytes a
// thread, blocks an SM at that shared size.  Returns a CUDA error (0 =
// none).
int hash_append_plan(long long rows, int L, int k, long long* out) {
  const Plan p = make_plan(rows, L, k);
  cudaFuncAttributes fa;
  int dev = 0, per_sm = 0;
  cudaError_t e = cudaFuncGetAttributes(&fa, k_hash_append);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(k_hash_append,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)p.smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k_hash_append,
                                                      NT, p.smem);
  const long long v[9] = {p.rpb, p.sw, p.segs, p.grid, (long long)p.smem,
                          (long long)fa.sharedSizeBytes, fa.numRegs,
                          (long long)fa.localSizeBytes, per_sm};
  for (int j = 0; j < 9; ++j) out[j] = v[j];
  return (int)e;
}

// Launch on `stream`.  packed/nmask (u8[rows][L/4], u8[rows][L/8]; L % 8
// == 0) or codes (u8[rows][L]; packed and nmask null) hold the bases,
// lengths int32[rows]; out (int64[rows * (L - k + 1)]) receives the keys
// and *nelts (int64) the count of valid windows.  1 <= k <= min(L, 63),
// 1 <= key_bits <= 63.  Returns the CUDA error of the launch (0 = none).
int hash_append_launch(const void* packed, const void* nmask,
                       const void* codes, const void* lengths,
                       long long rows, int L, int k, int key_bits, void* out,
                       void* nelts, void* stream) {
  if (rows <= 0 || L - k + 1 <= 0) return 0;
  const Plan p = make_plan(rows, L, k);
  if (p.grid > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  if (p.smem > DEFAULT_SMEM) {
    // the device's limit and the kernel's static part, asked every launch
    cudaFuncAttributes fa;
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, k_hash_append);
    if (e != cudaSuccess) return (int)e;
    if (p.smem + fa.sharedSizeBytes > (size_t)optin)
      return (int)cudaErrorInvalidValue;
    e = cudaFuncSetAttribute(k_hash_append,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)p.smem);
    if (e != cudaSuccess) return (int)e;
  }
  // cudaLaunchKernel returns this launch's own error, where
  // cudaGetLastError would also report an earlier call's
  u64 mask = (1ull << key_bits) - 1;
  int rpb = p.rpb, sw = p.sw, segs = p.segs;
  void* args[] = {&packed, &nmask, &codes, &lengths, &rows, &L, &k,
                  &mask, &rpb, &sw, &segs, &out, &nelts};
  return (int)cudaLaunchKernel(k_hash_append, dim3((unsigned)p.grid),
                               dim3(NT), args, p.smem,
                               (cudaStream_t)stream);
}

}  // extern "C"
