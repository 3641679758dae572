// The node probes of the Contiger: every successor and suffix-sibling
// probe of every node, with its hash key (kernel K8).
//
// Replaces the probe part of the JAX package's jax.jit programs
// phantom_candidates and build_oriented_graph (sh_assembly_tpu/models/
// contiger.py: _node_hashes, revcomp_packed, _succ_probes and
// _sibling_probes), which XLA fused on the TPU and which the port ran as a
// chain of some 400 small PyTorch kernels (probe_cuda.node_probes_plain).
//
// What one launch computes, a thread a node i of n, from its left-aligned
// k-mer (hi, lo) and its reverse complement (rhi, rlo):
//   fh, rh  the ntHash of the node's forward and reverse strands,
//           fh = XOR_j rol(seed(b_j), k - 1 - j), rh = XOR_j rol(cseed(b_j),
//           j) over its bases b_0..b_{k-1} (_node_hashes)
//   for o = 0 (hi, lo, fh, rh) and o = 1 (rhi, rlo, rh, fh), X = 0..3:
//     successor: the k-mer shifted one base left with X appended, its hash
//       by rolling (fh, rh) one base, key min(fh', rh') & mask, the
//       canonical pair (the unsigned min of the k-mer and its reverse
//       complement) and the flip (1 = the reverse complement is canonical)
//     sibling: base 0 replaced by X, its hash by swapping base 0's term,
//       key and canonical pair
// and writes row r of each [rows, n] output at r * n + i, in the chain's
// row order (successors o = 0 then o = 1, X = 0..3, then siblings alike):
//   graph mode:   keys[9] (the node's own key min(fh, rh) & mask, then the 8
//                 successors'), hi[8], lo[8], flip[8] (int32)
//   closure mode: keys[16], hi[16], lo[16] (8 successors, 8 siblings).
// Padding rows (-1, -1) go through the same arithmetic as any node: the
// result is the chain's, bit for bit, and the callers mask it.
//
// How: plain 64-bit integer code, one node a thread.  The four seeds and
// their complements are compile-time constants picked by two selects (a
// table indexed by a divergent base would serialise), the hash loop rolls
// fh left and a twin of rh right a base a step, and the reverse complement
// is a bit reversal and a swap of each 2-bit group's bits.
// What bounds it on an H100: bytes.  A node reads 16 bytes and writes 232
// (graph) or 384 (closure); its k-step hash and 8 or 16 probes take a few
// hundred 64-bit operations, a small fraction of the time the stores take
// at 3.35 TB/s.  Each output row is written by consecutive threads, so
// every store of a warp is one contiguous 256-byte run.

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int NT = 256;            // threads a block
constexpr int BLOCKS_PER_SM = 16;  // grid-stride launches
constexpr u64 LOW62 = 0x3FFFFFFFFFFFFFFFull;

// The published ntHash seeds (A, C, G, T) and their complements' (T, G, C,
// A), as utils/nthash.py has them.
constexpr u64 S0 = 0x3C8BFBB395C60474ull, S1 = 0x3193C18562A02B4Cull,
              S2 = 0x20323ED082572324ull, S3 = 0x295549F54BE24456ull;

__device__ __forceinline__ u64 seed(unsigned b) {
  const u64 x = (b & 1) ? S1 : S0, y = (b & 1) ? S3 : S2;
  return (b & 2) ? y : x;
}

// cseed(b) = seed(3 - b)
__device__ __forceinline__ u64 cseed(unsigned b) { return seed(3 - b); }

__device__ __forceinline__ u64 rol(u64 x, unsigned s) {
  s &= 63;
  return s ? (x << s) | (x >> (64 - s)) : x;
}

__device__ __forceinline__ u64 umin(u64 a, u64 b) { return a < b ? a : b; }

// Reverse the 32 2-bit groups of a word.
__device__ __forceinline__ u64 rev2(u64 x) {
  x = __brevll(x);
  return ((x >> 1) & 0x5555555555555555ull) |
         ((x & 0x5555555555555555ull) << 1);
}

// Reverse complement of a left-aligned k-mer, re-left-aligned
// (kmerpack.revcomp_packed).
__device__ __forceinline__ void revcomp(u64 hi, u64 lo, int k, u64& rh,
                                        u64& rl) {
  const u64 a = rev2(~lo), b = rev2(~hi);
  const int sh = 128 - 2 * k;
  if (sh == 0) {
    rh = a;
    rl = b;
  } else if (sh < 64) {
    rh = (a << sh) | (b >> (64 - sh));
    rl = b << sh;
  } else if (sh == 64) {
    rh = b;
    rl = 0;
  } else {
    rh = b << (sh - 64);
    rl = 0;
  }
}

// The canonical pair in place (kmerpack.canonicalize) -> the flip.
__device__ __forceinline__ bool canonical(u64& hi, u64& lo, int k) {
  u64 rh, rl;
  revcomp(hi, lo, k, rh, rl);
  const bool flip = rh < hi || (rh == hi && rl < lo);
  if (flip) {
    hi = rh;
    lo = rl;
  }
  return flip;
}

__global__ void __launch_bounds__(NT)
    k_node_probes(const u64* __restrict__ in_hi,
                  const u64* __restrict__ in_lo, long long n, int k, u64 mask,
                  int closure, u64* __restrict__ keys, u64* __restrict__ whi,
                  u64* __restrict__ wlo, int* __restrict__ flips) {
  const long long stride = (long long)gridDim.x * NT;
  const int key0 = closure ? 0 : 1;  // graph mode: row 0 is the node's
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < n;
       i += stride) {
    const u64 hi = in_hi[i], lo = in_lo[i];
    // fh rolls left a base a step; rt rolls right, so that rol(rt, k - 1)
    // holds base j's cseed rotated left by j
    u64 fh = 0, rt = 0;
    {
      u64 h = hi, l = lo;  // base j in bits 127..126 at step j
      for (int j = 0; j < k; ++j) {
        const unsigned b = (unsigned)(h >> 62);
        fh = rol(fh, 1) ^ seed(b);
        rt = rol(rt, 63) ^ cseed(b);
        h = (h << 2) | (l >> 62);
        l <<= 2;
      }
    }
    const u64 rh = rol(rt, k - 1);
    if (!closure) keys[i] = umin(fh, rh) & mask;
    u64 rhi, rlo;
    revcomp(hi, lo, k, rhi, rlo);
    for (int o = 0; o < 2; ++o) {
      const u64 ohi = o ? rhi : hi, olo = o ? rlo : lo;
      const u64 ofh = o ? rh : fh, orh = o ? fh : rh;
      const unsigned b0 = (unsigned)(ohi >> 62);
      // successors: drop base 0, append X
      const u64 sf = rol(ofh, 1) ^ rol(seed(b0), k);
      const u64 sr = rol(orh, 63) ^ rol(cseed(b0), 63);
      const u64 nhi = (ohi << 2) | (olo >> 62), nlo = olo << 2;
      for (unsigned X = 0; X < 4; ++X) {
        const long long r = 4 * o + X;
        keys[(r + key0) * n + i] =
            umin(sf ^ seed(X), sr ^ rol(cseed(X), k - 1)) & mask;
        u64 chi = nhi, clo = nlo;
        if (2 * k <= 64)
          chi |= (u64)X << (64 - 2 * k);
        else
          clo |= (u64)X << (128 - 2 * k);
        const bool flip = canonical(chi, clo, k);
        whi[r * n + i] = chi;
        wlo[r * n + i] = clo;
        if (!closure) flips[r * n + i] = flip;
      }
    }
    if (!closure) continue;
    for (int o = 0; o < 2; ++o) {
      const u64 ohi = o ? rhi : hi, olo = o ? rlo : lo;
      const u64 ofh = o ? rh : fh, orh = o ? fh : rh;
      const unsigned b0 = (unsigned)(ohi >> 62);
      // siblings: base 0 replaced by Y
      const u64 sf = ofh ^ rol(seed(b0), k - 1);
      const u64 sr = orh ^ cseed(b0);
      for (unsigned Y = 0; Y < 4; ++Y) {
        const long long r = 8 + 4 * o + Y;
        keys[r * n + i] = umin(sf ^ rol(seed(Y), k - 1), sr ^ cseed(Y)) & mask;
        u64 chi = (ohi & LOW62) | ((u64)Y << 62), clo = olo;
        canonical(chi, clo, k);
        whi[r * n + i] = chi;
        wlo[r * n + i] = clo;
      }
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream`.  hi/lo hold n nodes (u64 words); keys, hi_out,
// lo_out receive [rows, n] u64 words and, in graph mode (closure == 0),
// flips [8, n] int32: rows 9, 8, 8 (graph) or 16, 16, 16 (closure).  1 <= k
// <= 63, 1 <= key_bits <= 63.  Returns the CUDA error of the launch (0 =
// none).
int node_probes_launch(const void* hi, const void* lo, long long n, int k,
                       int key_bits, int closure, void* keys, void* hi_out,
                       void* lo_out, void* flips, void* stream) {
  if (n <= 0) return 0;
  if (k < 1 || k > 63 || key_bits < 1 || key_bits > 63)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  long long grid = (n + NT - 1) / NT;
  if (grid > (long long)sms * BLOCKS_PER_SM) grid = (long long)sms * BLOCKS_PER_SM;
  u64 mask = (1ull << key_bits) - 1;
  void* args[] = {&hi, &lo, &n, &k, &mask, &closure, &keys, &hi_out, &lo_out,
                  &flips};
  // cudaLaunchKernel returns this launch's own error, where
  // cudaGetLastError would also report an earlier call's
  return (int)cudaLaunchKernel(k_node_probes, dim3((unsigned)grid), dim3(NT),
                               args, 0, (cudaStream_t)stream);
}

}  // extern "C"
