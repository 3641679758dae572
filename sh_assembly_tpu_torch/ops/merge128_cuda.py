"""Kernel K3: the Contiger's node-store fold (128-bit dedup-merge).

Replaces the TPU kernel ``sh_assembly_tpu/ops/merge128_pallas.py:
merge128_planes`` with the hand-written CUDA kernel ``csrc/merge128.cu``
(its header says what bounds it on the card and how its one pass is laid
out).

Contract of ``merge128(a_hi, a_lo, a_nf, na, b_hi, b_lo, b_nf, cap)``:
  a_*: the node store, ``na`` live entries sorted by (hi, lo, nflag);
  b_*: the flush survivors sorted by (hi, lo, nflag), (-1, -1) sentinels
       allowed (they sort last and are dropped).
  hi/lo are int64 holding the unsigned words of a left-aligned packed
  k-mer, ordered unsigned; nflag is uint8, the inverted seed flag (0 =
  seed).  Returns (hi, lo, nflag, n_live) in fresh tensors: the union
  sorted by (hi, lo) with one entry per k-mer, the first copy under (hi,
  lo, nflag) order (so seed flags are ORed), a sentinel tail (nflag 1) to
  ``cap``, and n_live as a 0-dim int64 device tensor.  n_live may exceed
  ``cap``: the entries past it are not kept, and the caller raises.
  The inputs may be views at any offset: the kernel takes its 16-byte
  paths where the addresses allow and narrower ones elsewhere.

CUDA tensors launch the kernel, and any failure raises.  CPU tensors take
``merge128_plain``, the JAX package's sort fold (contiger.py:244-260) in
torch; the plain version also runs on CUDA tensors when called by name,
which is how the kernel is checked.
"""

from __future__ import annotations

import ctypes

import torch

from . import bits, kmerpack as kp

# Kernel launches (incremented once per launch of the CUDA kernel only).
LAUNCHES = 0

_lib = None


def _load():
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("merge128")
        lib.merge128_scratch_words.restype = ctypes.c_longlong
        lib.merge128_scratch_words.argtypes = [ctypes.c_longlong]
        lib.merge128_nlive_word.restype = ctypes.c_int
        lib.merge128_nlive_word.argtypes = []
        lib.merge128_launch.restype = ctypes.c_int
        lib.merge128_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # a hi/lo/nf
            ctypes.c_longlong,                                  # na
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # b hi/lo/nf
            ctypes.c_longlong,                                  # nb
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # out
            ctypes.c_longlong,                                  # cap
            ctypes.c_void_p,                                    # scratch
            ctypes.c_void_p,                                    # stream
        ]
        _lib = lib
    return _lib


def build() -> None:
    """Compile (if needed) and load the kernel library."""
    _load()


def _check_stream(hi, lo, nf, name: str) -> None:
    for t, dt in ((hi, torch.int64), (lo, torch.int64), (nf, torch.uint8)):
        if t.dtype != dt or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name}: hi/lo must be contiguous 1-D int64 "
                             f"and nflag contiguous 1-D uint8")
    if not hi.numel() == lo.numel() == nf.numel():
        raise ValueError(f"{name}: hi, lo and nflag differ in length")


def merge128_cuda(a_hi, a_lo, a_nf, na: int, b_hi, b_lo, b_nf, cap: int):
    """Launch K3 on the current CUDA stream (see module docstring)."""
    global LAUNCHES
    _check_stream(a_hi, a_lo, a_nf, "a")
    _check_stream(b_hi, b_lo, b_nf, "b")
    dev = a_hi.device
    inputs = (a_hi, a_lo, a_nf, b_hi, b_lo, b_nf)
    if not all(t.is_cuda and t.device == dev for t in inputs):
        raise ValueError("merge128_cuda needs all inputs on one GPU")
    if not 0 <= na <= a_hi.numel():
        raise ValueError(f"na {na} outside stream a")
    o_hi = torch.empty(cap, dtype=torch.int64, device=dev)
    o_lo = torch.empty(cap, dtype=torch.int64, device=dev)
    o_nf = torch.empty(cap, dtype=torch.uint8, device=dev)
    lib = _load()
    nb = b_hi.numel()
    # header (tile counter, n_live), tile descriptors and co-ranks in one
    # tensor; the launch zeroes what it must
    scratch = torch.empty(lib.merge128_scratch_words(na + nb),
                          dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.merge128_launch(
        a_hi.data_ptr(), a_lo.data_ptr(), a_nf.data_ptr(), na,
        b_hi.data_ptr(), b_lo.data_ptr(), b_nf.data_ptr(), nb,
        o_hi.data_ptr(), o_lo.data_ptr(), o_nf.data_ptr(), cap,
        scratch.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"merge128 kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return o_hi, o_lo, o_nf, scratch[lib.merge128_nlive_word()]


def merge128_plain(a_hi, a_lo, a_nf, na: int, b_hi, b_lo, b_nf, cap: int):
    """Pure-torch K3 on any device: the JAX package's sort fold.

    One lexicographic sort of the concatenation on (hi, lo, nflag); the
    first entry of each (hi, lo) run survives.  The survivors are already
    in order, so a boolean compaction stands in for the fold's second sort.
    """
    dev = a_hi.device
    h = torch.cat([a_hi[:na], b_hi])
    lo = torch.cat([a_lo[:na], b_lo])
    nf = torch.cat([a_nf[:na], b_nf])
    perm = kp.sort_pairs(h, lo, nf)
    sh, sl, sf = h[perm], lo[perm], nf[perm]
    first = torch.ones(sh.shape, dtype=torch.bool, device=dev)
    first[1:] = (sh[1:] != sh[:-1]) | (sl[1:] != sl[:-1])
    keep = first & ~((sh == bits.SENTINEL) & (sl == bits.SENTINEL))
    s_hi, s_lo, s_nf = sh[keep], sl[keep], sf[keep]
    n_live = s_hi.numel()
    m = min(n_live, cap)
    o_hi = torch.full((cap,), bits.SENTINEL, dtype=torch.int64, device=dev)
    o_lo = torch.full((cap,), bits.SENTINEL, dtype=torch.int64, device=dev)
    o_nf = torch.ones(cap, dtype=torch.uint8, device=dev)
    o_hi[:m], o_lo[:m], o_nf[:m] = s_hi[:m], s_lo[:m], s_nf[:m]
    return o_hi, o_lo, o_nf, torch.tensor(n_live, dtype=torch.int64,
                                          device=dev)


def merge128(a_hi, a_lo, a_nf, na: int, b_hi, b_lo, b_nf, cap: int):
    """K3 for CUDA tensors, its plain version for CPU tensors."""
    fn = merge128_cuda if a_hi.is_cuda else merge128_plain
    return fn(a_hi, a_lo, a_nf, na, b_hi, b_lo, b_nf, cap)
