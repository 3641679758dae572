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
// How: the prefix-XOR scan of tile_scan.cuh, shared with K6.  A block
// takes a tile (a group of whole rows, or a segment of a longer row),
// stages its bases once and scans their prefix XORs in shared memory
// (tile_scan.cuh says how), then writes one key a thread, thread = window
// in flat (row, window) order, so every warp's store is one contiguous
// 256-byte run: two 16-byte shared loads, two rotations, an unsigned min
// and a mask a key.  A thread steps its (row, window) by the block's
// stride, so no key needs a division.
// What bounds it on an H100: bytes.  Each key is 8 bytes written against a
// quarter byte of packed bases and an eighth of a byte of N mask read, so
// the floor is writing the keys once.  The scan is paid once a base (about
// 1.4 bases a key in rows of 160), not k shared-memory lookups a key as in
// the first version of this kernel, and a rotation is two funnel shifts
// (no shift by 64 at a rotation by 0).  A tile of 4096 bases takes about
// 72 KB of shared memory, above the 48 KB default: the launch queries the
// device's opt-in limit and sets the kernel's dynamic size on every launch
// (nothing is cached between launches), and three blocks fit an SM.

#include "tile_scan.cuh"

namespace {

using namespace tile;

// Dynamic shared bytes of a tile of n_t bases in nr rows: the scan's, then
// the rows' lengths.
size_t smem_bytes(int n_t, int nr) { return scan_bytes(n_t) + sizeof(int) * nr; }

__global__ void __launch_bounds__(NT, MIN_BLOCKS) k_hash_append(
    const uint8_t* __restrict__ packed, const uint8_t* __restrict__ nmask,
    const uint8_t* __restrict__ codes, const int* __restrict__ lengths,
    long long rows, int L, int k, u64 mask, int rpb, int sw, int segs,
    u64* __restrict__ out, u64* __restrict__ nelts) {
  __shared__ ulonglong2 s_seed[8];        // (seed, cseed) by code
  __shared__ ulonglong2 s_warp[NT / 32];  // the warps' (a, b) totals
  extern __shared__ __align__(16) uint8_t smem[];

  const int tid = threadIdx.x;
  const int W = L - k + 1;
  const Tile t = tile_of(rows, L, k, rpb, sw, segs);
  const long long row0 = t.row0;
  const int nr = t.nr, i0 = t.i0, nw = t.nw, ls = t.ls;
  ulonglong2* pq = reinterpret_cast<ulonglong2*>(smem);
  uint8_t* s_codes = smem + sizeof(ulonglong2) * (pidx(t.n_t) + 1);
  int* s_len = reinterpret_cast<int*>(s_codes + t.n_c);

  // 1. stage
  stage_codes(packed, nmask, codes, L, t, s_codes, s_seed);
  unsigned v = 0;
  if (tid < nr) {
    const int len = lengths[row0 + tid];
    s_len[tid] = len;
    v = (unsigned)max(0, min(len - k + 1 - i0, nw));
  }
  v = __reduce_add_sync(0xffffffffu, v);
  if ((tid & 31) == 0 && v) atomicAdd(nelts, (u64)v);
  __syncthreads();

  // 2. scan
  scan_tile(s_codes, pq, s_seed, s_warp, t);
  __syncthreads();

  // 3. keys: local key q = r * nw + i, stepped by NT = dr rows + di windows
  const int n_keys = nr * nw;
  const int dr = NT / nw, di = NT - dr * nw;
  int r = tid / nw, i = tid - r * nw;
  u64* dst = out + row0 * W + i0;
  for (int q = tid; q < n_keys; q += NT) {
    const unsigned col = (unsigned)(i0 + i);
    dst[q] = (int)col + k <= s_len[r]
                 ? window_hash(pq, r * ls + i, col, k) & mask
                 : ~0ull;
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
  const Tiling p = make_tiling(rows, L, k);
  const size_t smem = smem_bytes(p.n_t, p.rpb);
  out[0] = p.rpb;
  out[1] = p.sw;
  out[2] = p.segs;
  out[3] = p.grid;
  out[4] = (long long)smem;
  return (int)kernel_usage(k_hash_append, smem, out + 5);
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
  const Tiling p = make_tiling(rows, L, k);
  if (p.grid > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = smem_bytes(p.n_t, p.rpb);
  cudaError_t e = allow_smem(k_hash_append, smem);
  if (e != cudaSuccess) return (int)e;
  // cudaLaunchKernel returns this launch's own error, where
  // cudaGetLastError would also report an earlier call's
  u64 mask = (1ull << key_bits) - 1;
  int rpb = p.rpb, sw = p.sw, segs = p.segs;
  void* args[] = {&packed, &nmask, &codes, &lengths, &rows, &L, &k,
                  &mask, &rpb, &sw, &segs, &out, &nelts};
  return (int)cudaLaunchKernel(k_hash_append, dim3((unsigned)p.grid),
                               dim3(NT), args, smem, (cudaStream_t)stream);
}

}  // extern "C"
