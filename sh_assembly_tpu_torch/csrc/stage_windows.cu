// Stage a stack of read rows into the Contiger's pending candidate buffer:
// node collection's device step (kernel K6).
//
// Replaces the JAX package's collect staging,
// sh_assembly_tpu/models/contiger.py:_stage_super: a jax.jit program that
// unpacks the 2-bit transport, computes the canonical ntHash and key mask,
// runs the N-free window test and the seed flag, packs each window into
// 128 bits, takes the reverse complement and the canonical choice, and
// makes four masked writes into the pending buffer.  It reaches no
// pl.pallas_call; XLA fused it on the TPU, and on the card it is this
// kernel.  The mesh Contiger's collect (parallel/sharded_contiger.py)
// launches it too.
//
// What one launch computes, for R rows of L bases and W = L - k + 1
// windows a row, at e = row * W + i (row-major then window):
//   valid = i + k <= length[row];  ok = valid and no N or pad base (an
//   nmask bit) in bases [i, i + k)
//   hi[e], lo[e]  the canonical k-mer, left-aligned at bit 127 of the pair:
//                 the unsigned lexicographic min of the forward words and
//                 the reverse complement's, where ok; else -1, -1
//   key[e]        min(fh, rh) & (2^key_bits - 1) (the hash of K5) where ok,
//                 or where valid under the mesh rule (valid_keys); else -1
//   seed[e]       1 iff ok and i == seed_cols[row], else 0.
// N and pad bases hash through seed 0, as in K5.  A real k-mer's pair is
// never (-1, -1) at k <= 63: a left-aligned lo has its low 2 bits clear.
//
// How: the tiling, staging and prefix-XOR scan of tile_scan.cuh, shared
// with K5, give each window's hash from two prefix pairs.  After the scan
// the block also keeps its tile's bases as three bit streams in shared
// memory, built from the run of 16 codes the scan hands each thread: the
// forward bases 2 bits each, most significant first (16 a 32-bit word);
// the reverse complement of the whole tile, likewise; and one bit a base
// for N or pad.  A thread then takes one window at a time, in flat (row,
// window) order as K5 does: the forward k-mer is the 128 bits of the
// forward stream from the window's first base (five 32-bit words and four
// funnel shifts), cut to 2k bits; the reverse complement is the same from
// the reverse stream at n_c - a - k; the N-free test is the 64 bits of the
// N stream from the window's first base, cut to k.  So no window is packed
// base by base (the plain chain's k steps of five int64 kernels), no
// thread rolls a word over k - 1 bases of warm-up, and every store of a
// warp is one contiguous run: 256 bytes of each of hi, lo and key and 32
// of seed.
// What bounds it on an H100: bytes.  A window writes 25 bytes (three words
// and the seed flag) against about a third of a byte of packed bases and N
// mask read, so the floor is writing the four outputs once.  The work a
// window is two 16-byte and about fourteen 4-byte shared loads, a dozen
// funnel shifts, two rotations and two 128-bit compares.  A tile of 4096
// bases takes about 75 KB of shared memory (the scan's 70 KB, 2.5 KB of
// streams, the rows' lengths and seed columns), above the 48 KB default:
// every launch queries the device's opt-in limit and sets the kernel's
// dynamic size, and three blocks fit an SM.

#include "tile_scan.cuh"

namespace {

using namespace tile;

constexpr int PAD_WORDS = 4;  // zero words behind a 2-bit stream

// Words of the tile's three streams: 16 bases a word for the 2-bit ones,
// 32 for the N stream, each with zero words behind it for the reads of
// the last window.
__host__ __device__ __forceinline__ int stream_words(int n_c) {
  return 2 * (n_c / 16 + PAD_WORDS) + (n_c + 31) / 32 + 2;
}

// Dynamic shared bytes of a tile of n_t bases in nr rows: the scan's, the
// streams, then the rows' lengths and seed columns.
size_t smem_bytes(int n_t, int nr) {
  return scan_bytes(n_t) + sizeof(unsigned) * stream_words((n_t + 15) & ~15) +
         2 * sizeof(int) * nr;
}

// The 128 bits of a 2-bit stream from base a: base a in bits 127..126.
__device__ __forceinline__ void bits128(const unsigned* s, int a, u64& hi,
                                        u64& lo) {
  const unsigned* w = s + (a >> 4);
  const unsigned sh = 2 * (a & 15);
  const unsigned x0 = w[0], x1 = w[1], x2 = w[2], x3 = w[3], x4 = w[4];
  hi = ((u64)__funnelshift_l(x1, x0, sh) << 32) | __funnelshift_l(x2, x1, sh);
  lo = ((u64)__funnelshift_l(x3, x2, sh) << 32) | __funnelshift_l(x4, x3, sh);
}

// The 64 bits of the N stream from base a: base a in bit 0.
__device__ __forceinline__ u64 bits64(const unsigned* s, int a) {
  const unsigned* w = s + (a >> 5);
  const unsigned sh = a & 31;
  const unsigned y0 = w[0], y1 = w[1], y2 = w[2];
  return ((u64)__funnelshift_r(y1, y2, sh) << 32) | __funnelshift_r(y0, y1, sh);
}

__global__ void __launch_bounds__(NT, MIN_BLOCKS) k_stage_windows(
    const uint8_t* __restrict__ packed, const uint8_t* __restrict__ nmask,
    const int* __restrict__ lengths, const int* __restrict__ seed_cols,
    long long rows, int L, int k, u64 mask, int valid_keys, int rpb, int sw,
    int segs, u64* __restrict__ out_hi, u64* __restrict__ out_lo,
    u64* __restrict__ out_key, uint8_t* __restrict__ out_seed) {
  __shared__ ulonglong2 s_seed[8];        // (seed, cseed) by code
  __shared__ ulonglong2 s_warp[NT / 32];  // the warps' (a, b) totals
  extern __shared__ __align__(16) uint8_t smem[];

  const int tid = threadIdx.x;
  const int W = L - k + 1;
  const Tile t = tile_of(rows, L, k, rpb, sw, segs);
  const int n_w = t.n_c / 16;  // words of a 2-bit stream
  const int n_b = (t.n_c + 31) / 32;  // words of the N stream
  ulonglong2* pq = reinterpret_cast<ulonglong2*>(smem);
  uint8_t* s_codes = smem + sizeof(ulonglong2) * (pidx(t.n_t) + 1);
  unsigned* s_fwd = reinterpret_cast<unsigned*>(s_codes + t.n_c);
  unsigned* s_rc = s_fwd + n_w + PAD_WORDS;
  unsigned* s_bad = s_rc + n_w + PAD_WORDS;
  int* s_len = reinterpret_cast<int*>(s_bad + n_b + 2);
  int* s_col = s_len + t.nr;

  // 1. stage the codes, the rows' lengths and seed columns, and the
  // streams' zero tails
  stage_codes(packed, nmask, nullptr, L, t, s_codes, s_seed);
  if (tid < t.nr) {
    s_len[tid] = lengths[t.row0 + tid];
    s_col[tid] = seed_cols[t.row0 + tid];
  }
  if (tid < PAD_WORDS) s_fwd[n_w + tid] = s_rc[n_w + tid] = 0;
  if (tid < 2) s_bad[n_b + tid] = 0;
  __syncthreads();

  // 2. scan, and the streams from this thread's run of 16 codes: forward
  // word tid, reverse-complement word n_w - 1 - tid (base b of the tile at
  // position n_c - 1 - b), N bits [16 tid, 16 tid + 16)
  const uint4 raw = scan_tile(s_codes, pq, s_seed, s_warp, t);
  {
    const unsigned word[4] = {raw.x, raw.y, raw.z, raw.w};
    unsigned f = 0, rc = 0, nb = 0;
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
      const unsigned c = (word[j >> 2] >> (8 * (j & 3))) & 0xFF;
      f |= (c & 3) << (30 - 2 * j);
      rc |= (~c & 3) << (2 * j);
      nb |= (c >> 2) << j;
    }
    const bool mine = tid * RUN < t.n_c;
    if (mine) {
      s_fwd[tid] = f;
      s_rc[n_w - 1 - tid] = rc;
    }
    nb = mine ? nb : 0;
    const unsigned up = __shfl_down_sync(0xffffffffu, nb, 1);
    if (mine && !(tid & 1)) s_bad[tid >> 1] = nb | (up << 16);
  }
  __syncthreads();

  // 3. windows: local q = r * nw + i, stepped by NT = dr rows + di windows
  const int nw = t.nw, ls = t.ls;
  const int n_win = t.nr * nw;
  const int dr = NT / nw, di = NT - dr * nw;
  int r = tid / nw, i = tid - r * nw;
  const long long e0 = t.row0 * W + t.i0;
  const int nbits = 2 * k;
  const u64 m_hi = nbits >= 64 ? ~0ull : ~0ull << (64 - nbits);
  const u64 m_lo = nbits > 64 ? ~0ull << (128 - nbits) : 0ull;
  const u64 m_k = (1ull << k) - 1;
  for (int q = tid; q < n_win; q += NT) {
    const int a = r * ls + i;
    const unsigned col = (unsigned)(t.i0 + i);
    const bool valid = (int)col + k <= s_len[r];
    const bool ok = valid && (bits64(s_bad, a) & m_k) == 0;
    u64 key = ~0ull, hi = ~0ull, lo = ~0ull;
    if (valid_keys ? valid : ok) key = window_hash(pq, a, col, k) & mask;
    if (ok) {
      u64 fh, fl, rh, rl;
      bits128(s_fwd, a, fh, fl);
      bits128(s_rc, t.n_c - a - k, rh, rl);
      fh &= m_hi;
      fl &= m_lo;
      rh &= m_hi;
      rl &= m_lo;
      const bool flip = rh < fh || (rh == fh && rl < fl);
      hi = flip ? rh : fh;
      lo = flip ? rl : fl;
    }
    const long long e = e0 + q;
    out_hi[e] = hi;
    out_lo[e] = lo;
    out_key[e] = key;
    out_seed[e] = ok && (int)col == s_col[r];
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
int stage_windows_plan(long long rows, int L, int k, long long* out) {
  const Tiling p = make_tiling(rows, L, k);
  const size_t smem = smem_bytes(p.n_t, p.rpb);
  out[0] = p.rpb;
  out[1] = p.sw;
  out[2] = p.segs;
  out[3] = p.grid;
  out[4] = (long long)smem;
  return (int)kernel_usage(k_stage_windows, smem, out + 5);
}

// Launch on `stream`.  packed/nmask (u8[rows][L/4], u8[rows][L/8]; L % 8
// == 0) hold the bases, lengths and seed_cols int32[rows]; hi, lo, key
// (int64) and seed (u8), each of rows * (L - k + 1) entries from the
// pointer given, receive the windows.  valid_keys != 0 writes the key of
// every valid window (the mesh rule), 0 of every ok one.  1 <= k <=
// min(L, 63), 1 <= key_bits <= 63.  Returns the CUDA error of the launch
// (0 = none).
int stage_windows_launch(const void* packed, const void* nmask,
                         const void* lengths, const void* seed_cols,
                         long long rows, int L, int k, int key_bits,
                         int valid_keys, void* hi, void* lo, void* key,
                         void* seed, void* stream) {
  if (rows <= 0 || L - k + 1 <= 0) return 0;
  const Tiling p = make_tiling(rows, L, k);
  if (p.grid > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = smem_bytes(p.n_t, p.rpb);
  cudaError_t e = allow_smem(k_stage_windows, smem);
  if (e != cudaSuccess) return (int)e;
  // cudaLaunchKernel returns this launch's own error, where
  // cudaGetLastError would also report an earlier call's
  u64 mask = (1ull << key_bits) - 1;
  int rpb = p.rpb, sw = p.sw, segs = p.segs;
  void* args[] = {&packed, &nmask, &lengths, &seed_cols, &rows, &L,
                  &k, &mask, &valid_keys, &rpb, &sw, &segs, &hi, &lo, &key,
                  &seed};
  return (int)cudaLaunchKernel(k_stage_windows, dim3((unsigned)p.grid),
                               dim3(NT), args, smem, (cudaStream_t)stream);
}

}  // extern "C"
