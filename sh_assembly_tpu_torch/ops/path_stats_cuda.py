"""Kernel K11: each kept path's median count, count sum and seed flag,
where K10 leaves the members.

The medians step of the host assembly in ``models/contiger._finalize_host``
(the JAX package's ``_finalize_host``: a ``np.lexsort`` of every member by
(path, count), the median read at each path's middle, ``np.add.reduceat``
for the sums and the seed flags).  K10 (``ops/members_cuda``) leaves each
path's members contiguous, so a median is a selection within one segment
and no global sort is needed: the hand-written CUDA kernels of
``csrc/path_stats.cu`` take a path a warp, or the longer ones a block
(its header says what bounds them on the card and what the design does
about it), and only per-path results are written.

Contract of ``path_stats(counts, starts, ai, seed, smin, smax)``:
  counts, ai: contiguous 1-D int32 tensors of the M_mem members (K10's
        counts and oriented indices); starts: int32[P], each path's first
        member, increasing from 0, every path at least one member (K10's);
  seed: a bool or uint8 tensor over the nodes (read at ai >> 1), or None
        for no seed mask; smin, smax: the solid range; all on one device.
  Returns (med int64[P], sum int64[P], flag bool[P]): the median (odd
  length: the middle count; even: (a + b) // 2 of the two middle ones),
  the sum of the counts (the mean is float64(sum) / length) and whether
  some member's count lies in [smin, smax] with its node's seed set.  Bit
  for bit the JAX package's medians, sums and seed flags.

``path_stats`` dispatches: CUDA tensors take ``path_stats_cuda`` (two
launches, nothing synchronises), any other tensor the plain twin
``path_stats_plain``, a torch mirror of the lexsort (one sort of
(path << 32) | count), which also runs on CUDA tensors when called by
name (how the kernel is checked).
"""

from __future__ import annotations

import ctypes

import torch

# Calls into the kernel library (incremented once per ``path_stats_cuda``
# call: its short-path and long-path launches).
LAUNCHES = 0

_lib = None

_P = ctypes.c_void_p
_I64 = (-(1 << 63), (1 << 63) - 1)


def _load():
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("path_stats")
        lib.path_stats_launch.restype = ctypes.c_int
        lib.path_stats_launch.argtypes = [
            _P, _P, _P, _P,                       # counts, starts, ai, seed
            ctypes.c_longlong, ctypes.c_longlong,  # smin, smax
            ctypes.c_int, ctypes.c_int,           # M_mem, P
            _P, _P, _P, _P, _P, _P,               # med .. ctr, stream
        ]
        lib.path_stats_warp_max.restype = ctypes.c_int
        lib.path_stats_warp_max.argtypes = []
        lib.path_stats_stage.restype = ctypes.c_int
        lib.path_stats_stage.argtypes = []
        _lib = lib
    return _lib


def build() -> None:
    """Compile (if needed) and load the kernel library."""
    _load()


def limits() -> dict:
    """The built kernel's path lengths: the longest a warp takes and the
    longest a block stages in shared memory."""
    lib = _load()
    return {"warp_max": lib.path_stats_warp_max(),
            "stage": lib.path_stats_stage()}


def check(counts, starts, ai, seed, smin, smax) -> None:
    """Refuse what ``path_stats`` does not take (module docstring)."""
    M = counts.numel()
    for name, t, n in (("counts", counts, M), ("ai", ai, M),
                       ("starts", starts, starts.numel())):
        if t.dtype != torch.int32 or t.shape != (n,):
            raise ValueError(f"{name} must be a 1-D int32 tensor of {n} "
                             f"entries")
        if t.device != counts.device:
            raise ValueError(f"{name} is on {t.device}, counts on "
                             f"{counts.device}")
    if seed is not None:
        if seed.dtype not in (torch.bool, torch.uint8) or seed.dim() != 1:
            raise ValueError("seed must be a 1-D bool or uint8 tensor")
        if seed.device != counts.device:
            raise ValueError(f"seed is on {seed.device}, counts on "
                             f"{counts.device}")
    if M >= 1 << 31:
        raise ValueError("int32 indices hold fewer than 2^31 members")
    if starts.numel() > M or (M and starts.numel() == 0):
        raise ValueError(f"{starts.numel()} paths for {M} members")
    for name, v in (("smin", smin), ("smax", smax)):
        if not _I64[0] <= int(v) <= _I64[1]:
            raise ValueError(f"{name} {v} outside int64")


def _cuda_args(*ts) -> None:
    for t in ts:
        if not t.is_cuda:
            raise ValueError("K11's launches need their tensors on a GPU")
        if not t.is_contiguous():
            raise ValueError("K11's tensors must be contiguous")


def path_stats_cuda(counts, starts, ai, seed, smin: int, smax: int):
    """Launch K11 on counts' GPU and current stream (module docstring).
    Nothing synchronises."""
    global LAUNCHES
    check(counts, starts, ai, seed, smin, smax)
    _cuda_args(counts, starts, ai, *([] if seed is None else [seed]))
    P, dev = starts.numel(), counts.device

    def out(dtype, n=P):
        return torch.empty(n, dtype=dtype, device=dev)

    med, total, flag = out(torch.int64), out(torch.int64), out(torch.bool)
    long_list, ctr = out(torch.int32), out(torch.int32, 2)
    with torch.cuda.device(dev):
        rc = _load().path_stats_launch(
            counts.data_ptr(), starts.data_ptr(), ai.data_ptr(),
            None if seed is None else seed.data_ptr(), int(smin), int(smax),
            counts.numel(), P, med.data_ptr(), total.data_ptr(),
            flag.data_ptr(), long_list.data_ptr(), ctr.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"path_stats kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES += 1
    return med, total, flag


def path_stats_plain(counts, starts, ai, seed, smin: int, smax: int):
    """Pure-torch twin of K11 on any device: the lexsort's semantics, one
    sort of (path << 32) | (count + 2^31)."""
    check(counts, starts, ai, seed, smin, smax)
    M, P, dev = counts.numel(), starts.numel(), counts.device
    st = starts.long()
    lens = torch.diff(st, append=torch.tensor([M], device=dev))
    seg = torch.repeat_interleave(torch.arange(P, device=dev), lens)
    c = counts.long()
    order = torch.sort((seg << 32) | (c + (1 << 31))).values
    sc = (order & 0xFFFFFFFF) - (1 << 31)  # each path's counts, sorted
    mid = st + lens // 2
    med = torch.where(lens % 2 == 1, sc[mid],
                      torch.div(sc[(mid - 1).clamp(min=0)] + sc[mid], 2,
                                rounding_mode="floor"))
    total = torch.zeros(P, dtype=torch.int64, device=dev).index_add_(0, seg,
                                                                     c)
    hit = (c >= smin) & (c <= smax)
    if seed is not None:
        hit &= seed[ai.long() >> 1] != 0
    flag = torch.zeros(P, dtype=torch.int64, device=dev).index_add_(
        0, seg, hit.long()) > 0
    return med, total, flag


def path_stats(counts, starts, ai, seed, smin: int, smax: int):
    """K11 on CUDA tensors, its plain twin otherwise."""
    fn = path_stats_cuda if counts.is_cuda else path_stats_plain
    return fn(counts, starts, ai, seed, smin, smax)
