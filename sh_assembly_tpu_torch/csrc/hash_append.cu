// Hash and append a stack of read batches to the counting buffer: the
// counting stage's device step (kernel K5).
//
// Replaces the JAX package's fused counting scan,
// sh_assembly_tpu/models/counter.py:append_scan_packed (and append_scan,
// count_batch): an XLA-fused lax.scan over S batches that unpacks the
// 2-bit transport, computes the canonical ntHash of every window, masks it
// to key_bits and appends it to the log buffer.  It reaches no
// pl.pallas_call; XLA fused it on the TPU, and on the card it is this
// kernel.
//
// What one launch computes, for R = S * B rows of L bases and W = L - k + 1
// windows a row: out[row * W + i] for every row and window, in row-major
// then window order (the order S consecutive single-batch appends write),
//   -1                                    if i + k > length[row]
//   min(fh, rh) & (2^key_bits - 1)        otherwise, with
//   fh = XOR_{t<k} rol(seed(c[i+t]), k-1-t),  rh = XOR_{t<k} rol(cseed(c[i+t]), t)
// (unsigned min; the formula of ops/nthash.py).  N and pad bases (an nmask
// bit set, or a code >= 4) have seed 0: they are hashed, not skipped.  The
// count of valid windows, sum over rows of clamp(length - k + 1, 0, W), is
// added to *nelts.  k <= 63, so no rotation here is by 64.
//
// What bounds it on an H100: bytes.  Each key is 8 bytes written against a
// quarter byte of packed bases and an eighth of a byte of N mask read, so
// the floor is writing the keys once.  Design: a block stages the base
// codes of a group of rows in shared memory (unpacked from the transport,
// N and pad as code 4) beside two tables of rotated seeds, tf[r][c] =
// rol(seed(c), r) and tr[r][c] = rol(cseed(c), r), eight codes a row of the
// table so that the codes a warp looks up at one rotation fall in distinct
// banks.  Each thread then computes whole windows from scratch, k table
// lookups a hash, so neighbouring threads compute and store neighbouring
// keys and every store of a warp is one contiguous 256-byte run.  This
// spends about k shared-memory lookups a key where a rolling hash would
// spend a few: a simple kernel first; rolling over runs of windows a thread
// is the lead if it ever shows.  Nothing is cached between launches: the
// grid follows the rows, and the shared memory stays under 48 KB.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;              // threads a block
constexpr int STAGE_BYTES = 4096;    // base codes a block stages (rows x L)
constexpr int MAX_ROWS = 32;         // rows a block at most
constexpr int N_CODE = 4;            // N and pad: seed 0

typedef unsigned long long u64;

// The published ntHash seeds (A, C, G, T) and their complements' (T, G, C,
// A), as utils/nthash.py has them.
__constant__ u64 SEEDS[4] = {0x3C8BFBB395C60474ull, 0x3193C18562A02B4Cull,
                             0x20323ED082572324ull, 0x295549F54BE24456ull};
__constant__ u64 CSEEDS[4] = {0x295549F54BE24456ull, 0x20323ED082572324ull,
                              0x3193C18562A02B4Cull, 0x3C8BFBB395C60474ull};

__device__ __forceinline__ u64 rol(u64 x, int s) {
  s &= 63;
  return s == 0 ? x : (x << s) | (x >> (64 - s));  // x >> 64 is undefined
}

__global__ void __launch_bounds__(NT) k_hash_append(
    const uint8_t* __restrict__ packed, const uint8_t* __restrict__ nmask,
    const uint8_t* __restrict__ codes, const int* __restrict__ lengths,
    long long rows, int L, int k, u64 mask, int rows_per_block,
    u64* __restrict__ out, u64* __restrict__ nelts) {
  __shared__ u64 tf[64][8];
  __shared__ u64 tr[64][8];
  __shared__ u64 s_valid;
  extern __shared__ __align__(16) uint8_t smem[];
  // dynamic part: lengths int[rows_per_block], then codes u8[rows x L]
  int* s_len = reinterpret_cast<int*>(smem);
  uint8_t* s_codes = smem + 4 * rows_per_block;

  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const int nr = (int)min((long long)rows_per_block, rows - row0);
  const int W = L - k + 1;

  for (int e = tid; e < 64 * 8; e += NT) {
    const int r = e >> 3, c = e & 7;
    tf[r][c] = c < N_CODE ? rol(SEEDS[c], r) : 0ull;
    tr[r][c] = c < N_CODE ? rol(CSEEDS[c], r) : 0ull;
  }
  if (tid == 0) s_valid = 0;
  __syncthreads();
  if (tid < nr) {
    const int len = lengths[row0 + tid];
    s_len[tid] = len;
    const int v = max(0, min(len - k + 1, W));
    if (v) atomicAdd(&s_valid, (u64)v);
  }
  // the rows' bases as codes 0..3, 4 for N and pad
  const int n_bases = nr * L;
  if (codes != nullptr) {
    const uint8_t* src = codes + row0 * L;
    for (int j = tid; j < n_bases; j += NT) {
      const uint8_t c = src[j];
      s_codes[j] = c < N_CODE ? c : N_CODE;
    }
  } else {
    // L % 8 == 0: the rows' packed bytes and mask bytes are contiguous
    const uint8_t* pk = packed + row0 * (L / 4);
    const uint8_t* nm = nmask + row0 * (L / 8);
    for (int j = tid; j < n_bases; j += NT) {
      const int bad = (nm[j >> 3] >> (j & 7)) & 1;
      s_codes[j] = bad ? N_CODE : (pk[j >> 2] >> (2 * (j & 3))) & 3;
    }
  }
  __syncthreads();
  if (tid == 0 && s_valid) atomicAdd(nelts, s_valid);

  u64* dst = out + row0 * W;
  const int n_win = nr * W;
  for (int q = tid; q < n_win; q += NT) {
    const int r = q / W, i = q - r * W;
    u64 key = ~0ull;
    if (i + k <= s_len[r]) {
      const uint8_t* c = s_codes + r * L + i;
      u64 fh = 0, rh = 0;
#pragma unroll 4
      for (int t = 0; t < k; ++t) {
        const int ct = c[t];
        fh ^= tf[k - 1 - t][ct];
        rh ^= tr[t][ct];
      }
      key = (fh < rh ? fh : rh) & mask;
    }
    dst[q] = key;
  }
}

}  // namespace

extern "C" {

// Rows a block takes for rows of L bases.
int hash_append_rows_per_block(int L) {
  const int r = L > 0 ? STAGE_BYTES / L : MAX_ROWS;
  return r < 1 ? 1 : (r > MAX_ROWS ? MAX_ROWS : r);
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
  if (rows <= 0) return 0;
  const int rpb = hash_append_rows_per_block(L);
  const size_t smem = 4 * (size_t)rpb + (size_t)rpb * L;
  const long long grid = (rows + rpb - 1) / rpb;
  const u64 mask = (1ull << key_bits) - 1;
  k_hash_append<<<(unsigned)grid, NT, smem, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(packed), static_cast<const uint8_t*>(nmask),
      static_cast<const uint8_t*>(codes), static_cast<const int*>(lengths),
      rows, L, k, mask, rpb, static_cast<u64*>(out), static_cast<u64*>(nelts));
  return (int)cudaGetLastError();
}

}  // extern "C"
