// The tiling and the prefix-XOR scan shared by kernels K5 (hash_append.cu)
// and K6 (stage_windows.cu).
//
// Both kernels hash every k-window of R rows of L bases with the
// prefix-XOR identity of ops/nthash.py.  With a_j = rol(seed(c_j), -j mod
// 64), b_j = rol(cseed(c_j), j mod 64) for the absolute column j of a row,
// and P, Q their exclusive prefix XORs,
//   fh(i) = rol(P[i+k] ^ P[i], (k-1+i) mod 64),  rh(i) = rol(Q[i+k] ^ Q[i], -i mod 64),
// bit for bit (XOR is exact).  A block takes a tile: a group of whole rows,
// or a segment of a row longer than a tile (segments overlap by k - 1
// bases and rotate by their absolute columns).  Either way the tile's
// bases are one contiguous run of the input, which the block
//   1. stages in shared memory as codes, N and pad as code 4
//      (stage_codes);
//   2. scans as one sequence (scan_tile): each thread computes (a, b) of a
//      run of 16 bases into their slots and XORs them, a shuffle scan
//      across the warp and the warps' totals give each run its start, and
//      the thread turns its slots into P and Q in place (16 B a base, one
//      pad slot every 16 so that the runs' accesses fall in distinct
//      banks).  The rows of a tile need no reset: P[i+k] ^ P[i] of a window
//      inside a row cancels every row before it.
// Each kernel then computes its windows from the prefix pairs, one window
// a thread in flat (row, window) order.  A tile of 4096 bases takes about
// 70 KB of shared memory for the scan, above the 48 KB default: a launch
// queries the device's opt-in limit and sets the kernel's dynamic size
// every time (allow_smem; nothing is cached between launches).

#pragma once

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace tile {

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

// Bytes of the scan's shared memory for a tile of n_t bases: the prefix
// pairs, then the codes (a whole uint4 a thread).
__host__ __device__ __forceinline__ size_t scan_bytes(int n_t) {
  return sizeof(ulonglong2) * (pidx(n_t) + 1) + ((n_t + 15) & ~15);
}

// How a launch is cut into tiles.
struct Tiling {
  int rpb;         // rows a tile (1 for segments)
  int sw;          // windows a segment (W for whole rows)
  int segs;        // segments a row (1 for whole rows)
  long long grid;  // blocks
  int n_t;         // bases of the largest tile
};

inline Tiling make_tiling(long long rows, int L, int k) {
  const int W = L - k + 1;
  Tiling p;
  if (L <= TILE) {
    p.rpb = TILE / L < MAX_ROWS ? TILE / L : MAX_ROWS;
    p.sw = W;
    p.segs = 1;
    p.grid = (rows + p.rpb - 1) / p.rpb;
    p.n_t = (int)(rows < p.rpb ? rows : p.rpb) * L;
  } else {
    p.rpb = 1;
    p.sw = (TILE - (k - 1)) & ~7;  // segments start at multiples of 8 bases
    p.segs = (W + p.sw - 1) / p.sw;
    p.grid = rows * p.segs;
    p.n_t = TILE;
  }
  return p;
}

// This block's tile: windows [i0, i0 + nw) of rows [row0, row0 + nr),
// staged bases [i0, i0 + ls) of each; n_t bases in all, n_c rounded up to
// a whole run.
struct Tile {
  long long row0;
  int nr, i0, nw, ls, n_t, n_c;
};

__device__ __forceinline__ Tile tile_of(long long rows, int L, int k,
                                        int rpb, int sw, int segs) {
  Tile t;
  if (segs == 1) {
    t.row0 = (long long)blockIdx.x * rpb;
    t.nr = (int)min((long long)rpb, rows - t.row0);
    t.i0 = 0;
    t.nw = L - k + 1;
  } else {
    t.row0 = blockIdx.x / segs;
    t.i0 = (int)(blockIdx.x - t.row0 * segs) * sw;
    t.nr = 1;
    t.nw = min(sw, L - k + 1 - t.i0);
  }
  t.ls = t.nw + k - 1;  // L for whole rows
  t.n_t = t.nr * t.ls;
  t.n_c = (t.n_t + 15) & ~15;
  return t;
}

// 1. Stage the tile's codes (0..3, N and pad as N_CODE) into s_codes[0,
// n_c) and the seeds by code into s_seed[8], from packed/nmask (L % 8 ==
// 0) or from codes (packed and nmask null).  Fixed trip counts, so that
// every load of a thread is in flight at once.  The caller synchronises.
__device__ __forceinline__ void stage_codes(const uint8_t* __restrict__ packed,
                                            const uint8_t* __restrict__ nmask,
                                            const uint8_t* __restrict__ codes,
                                            int L, const Tile& t,
                                            uint8_t* s_codes,
                                            ulonglong2* s_seed) {
  const int tid = threadIdx.x;
  if (tid < 8)
    s_seed[tid] = tid < N_CODE ? make_ulonglong2(SEEDS[tid], CSEEDS[tid])
                               : make_ulonglong2(0ull, 0ull);
  const long long g0 = t.row0 * L + t.i0;
  if (codes != nullptr) {
    const uint8_t* src = codes + g0;
#pragma unroll
    for (int m = 0; m < RUN; ++m) {
      const int e = m * NT + tid;
      if (e < t.n_c) {
        const uint8_t c = e < t.n_t ? src[e] : N_CODE;
        s_codes[e] = c < N_CODE ? c : N_CODE;
      }
    }
  } else {
    // g0 % 8 == 0 (whole rows of L % 8 == 0, segments starting at
    // multiples of 8): eight bases a thread from two packed bytes and one
    // mask byte
    const uint16_t* pk = reinterpret_cast<const uint16_t*>(packed + g0 / 4);
    const uint8_t* nm = nmask + g0 / 8;
#pragma unroll
    for (int m = 0; m < RUN / 8; ++m) {
      const int e = m * NT + tid, b = 8 * e;
      if (b < t.n_c) {
        u64 eight = 0x0404040404040404ull;
        if (b < t.n_t) {
          const unsigned p = pk[e], bad = nm[e];
          eight = 0;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const u64 c = b + j >= t.n_t || (bad >> j) & 1 ? N_CODE
                                                           : (p >> (2 * j)) & 3;
            eight |= c << (8 * j);
          }
        }
        *reinterpret_cast<u64*>(s_codes + b) = eight;
      }
    }
  }
}

// 2. Scan the staged tile into its prefix pairs pq[pidx(0) .. pidx(n_t)]
// (P[n_t] closes the tile).  Called by every thread after the staging's
// barrier; synchronises once inside, and the caller synchronises before
// reading pq.  Returns this thread's run of codes, bases [16 tid, 16 tid +
// 16) of the tile (N_CODE past the tile).
__device__ __forceinline__ uint4 scan_tile(const uint8_t* s_codes,
                                           ulonglong2* pq,
                                           const ulonglong2* s_seed,
                                           ulonglong2* s_warp, const Tile& t) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_t = t.n_t;
  // this thread's run [t0, t0 + RUN), its columns from c0; the run's (a,
  // b) go to its slots, then their prefixes over them
  const int t0 = tid * RUN;
  uint4 raw = make_uint4(0x04040404u, 0x04040404u, 0x04040404u, 0x04040404u);
  if (t0 < n_t) raw = *reinterpret_cast<const uint4*>(s_codes + t0);
  const unsigned word[4] = {raw.x, raw.y, raw.z, raw.w};
  ulonglong2* run = pq + pidx(t0);
  u64 xa = 0, xb = 0;
  {
    int c = t0 < n_t ? t0 % t.ls : 0;
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
      const ulonglong2 sd = s_seed[(word[j >> 2] >> (8 * (j & 3))) & 0xFF];
      const unsigned col = (unsigned)(t.i0 + c);
      const u64 a = rol(sd.x, (0u - col) & 63), b = rol(sd.y, col & 63);
      if (t0 + j < n_t) run[j] = make_ulonglong2(a, b);
      xa ^= a;
      xb ^= b;
      c = c + 1 == t.ls ? 0 : c + 1;
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
  return raw;
}

// The canonical hash of the window at tile position a (absolute column
// col) from the prefix pairs: min(fh, rh), unsigned.
__device__ __forceinline__ u64 window_hash(const ulonglong2* pq, int a,
                                           unsigned col, int k) {
  const ulonglong2 lo = pq[pidx(a)], hi = pq[pidx(a + k)];
  const u64 fh = rol(hi.x ^ lo.x, (col + k - 1) & 63);
  const u64 rh = rol(hi.y ^ lo.y, (0u - col) & 63);
  return fh < rh ? fh : rh;
}

// Set `kernel`'s dynamic shared size to smem where it is above the 48 KB
// default, after checking it against the device's opt-in limit less the
// kernel's static part; both are asked on every call.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= DEFAULT_SMEM) return cudaSuccess;
  cudaFuncAttributes fa;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return e;
  if (smem + fa.sharedSizeBytes > (size_t)optin) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// What the built kernel uses at a dynamic shared size, into out[4]: static
// shared bytes, registers a thread, local (spill) bytes a thread, blocks an
// SM.
template <typename Kernel>
cudaError_t kernel_usage(Kernel kernel, size_t smem, long long* out) {
  cudaFuncAttributes fa = {};
  int per_sm = 0;
  cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                      smem);
  out[0] = (long long)fa.sharedSizeBytes;
  out[1] = fa.numRegs;
  out[2] = (long long)fa.localSizeBytes;
  out[3] = per_sm;
  return e;
}

}  // namespace tile
