"""Kernel K9: the contraction of the Contiger's chain forest on the card.

Replaces, where the forest lies on a CUDA device, the three host steps of
``models/contiger.finalize_unitigs``: the walk ``contract_paths_host``
(``cpp/contract.cpp``), the numpy ``kmerpack_np.revcomp_packed`` and the
mirror keep rule ``_path_summary_np`` (the JAX package's ``contract_paths``,
``kmerpack.revcomp_packed`` and ``_path_summary_np``), with the
hand-written CUDA kernels of ``csrc/contract.cu``: a sparse ruling set ranks
the forest, one launch takes the reverse complements and one the keep rule
(its header says what bounds it on the card and what the design does about
it).  So only what the host assembly reads crosses to the host.

Contract of ``contract(chain_next, hi, lo, k)``:
  chain_next: contiguous 1-D int32 tensor of M = 2 Np oriented successor
        indices, -1 = none; targets unique (the indeg-1 rule), so the
        forest is pure paths and pure cycles;
  hi, lo: contiguous 1-D int64 tensors of the Np node k-mers, left-aligned
        (``kmerpack``), sentinel rows allowed, on the same device; 1 <= k
        <= 63.
  Returns (head int32[M], dist int32[M], keep bool[M], rhi int64[Np],
  rlo int64[Np], n_bad int32[1]), bit for bit what ``contract_paths_host``
  (head, dist), ``revcomp_packed`` and ``_path_summary_np`` give: cycles
  cut at their least oriented index, k-mer words ordered unsigned.
  n_bad counts chain targets out of range or shared by two nodes, which
  the forest never has; the other outputs mean nothing where it is not 0.

CUDA tensors launch the kernels (``rank_cuda``, ``revcomp_cuda``,
``keep_cuda``, in that order), nothing synchronises, and a refused launch
raises; the caller reads n_bad with its copies.  CPU tensors take
``contract_plain``: ``contiger.contract_paths`` (pointer jumping),
``kmerpack.revcomp_packed`` and ``keep_rule_plain``, a torch mirror of
``_path_summary_np``, which raises where n_bad is not 0; it also runs on
CUDA tensors when called by name, which is how the kernels are checked.
"""

from __future__ import annotations

import ctypes

import torch

from . import kmerpack as kp

# Calls into the kernel library (incremented once per C entry launched: a
# ranking, a reverse complement and a keep rule a contraction).
LAUNCHES = 0

_lib = None


def _load():
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("contract")
        lib.contract_slots.restype = ctypes.c_int
        lib.contract_slots.argtypes = [ctypes.c_int]
        lib.contract_slot_rows.restype = ctypes.c_int
        lib.contract_slot_rows.argtypes = []
        lib.contract_rank_launch.restype = ctypes.c_int
        lib.contract_rank_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int,     # next, M
            ctypes.c_void_p, ctypes.c_void_p,  # head, dist
            ctypes.c_void_p, ctypes.c_void_p,  # tail_of, slots
            ctypes.c_void_p, ctypes.c_void_p,  # bad, stream
        ]
        lib.contract_revcomp_launch.restype = ctypes.c_int
        lib.contract_revcomp_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # hi, lo, n
            ctypes.c_int,                                    # k
            ctypes.c_void_p, ctypes.c_void_p,                # rhi, rlo
            ctypes.c_void_p,                                 # stream
        ]
        lib.contract_keep_launch.restype = ctypes.c_int
        lib.contract_keep_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,  # hi, lo
            ctypes.c_void_p, ctypes.c_void_p,  # rhi, rlo
            ctypes.c_int,                      # n
            ctypes.c_void_p, ctypes.c_void_p,  # head, tail_of
            ctypes.c_void_p, ctypes.c_void_p,  # keep, stream
        ]
        _lib = lib
    return _lib


def build() -> None:
    """Compile (if needed) and load the kernel library."""
    _load()


def check(chain_next, hi, lo, k) -> None:
    """Refuse what ``contract`` does not take (module docstring)."""
    if chain_next.dtype != torch.int32 or chain_next.dim() != 1:
        raise ValueError("chain_next must be a 1-D int32 tensor")
    for name, t in (("hi", hi), ("lo", lo)):
        if t.dtype != torch.int64 or t.dim() != 1:
            raise ValueError(f"{name} must be a 1-D int64 tensor")
        if t.device != chain_next.device:
            raise ValueError(f"{name} is on {t.device}, chain_next on "
                             f"{chain_next.device}")
    if lo.numel() != hi.numel() or chain_next.numel() != 2 * hi.numel():
        raise ValueError("chain_next must hold 2 oriented nodes a node of "
                         "hi and lo")
    if chain_next.numel() >= 1 << 31:
        raise ValueError("int32 indices hold fewer than 2^31 oriented nodes")
    if not 1 <= k <= 63:
        raise ValueError(f"k {k} outside [1, 63]")


def _cuda_args(*ts, dtype=None, n=None):
    """Refuse CPU, strided, or (where given) mistyped or mis-sized tensors."""
    for t in ts:
        if (dtype is not None and t.dtype != dtype) or \
                (n is not None and t.shape != (n,)):
            raise ValueError(f"K9 takes 1-D {dtype} tensors of {n} entries "
                             f"here")
        if not t.is_cuda:
            raise ValueError("K9's launches need their tensors on a GPU")
        if not t.is_contiguous():
            raise ValueError("K9's tensors must be contiguous")


def _launched(what: str, rc: int) -> None:
    global LAUNCHES
    if rc != 0:
        raise RuntimeError(f"contract {what} kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES += 1


def rank_cuda(chain_next: torch.Tensor):
    """K9's ranking of the forest on chain_next's GPU and current stream ->
    (head int32[M], dist int32[M], tail_of int32[M], n_bad int32[1]):
    tail_of holds, at each head, the last node of its path (elsewhere
    scratch)."""
    if chain_next.dtype != torch.int32 or chain_next.dim() != 1 or \
            chain_next.numel() >= 1 << 31:
        raise ValueError("chain_next must be a 1-D int32 tensor of fewer "
                         "than 2^31 oriented nodes")
    _cuda_args(chain_next)
    M, dev = chain_next.numel(), chain_next.device
    head, dist, tail_of = (torch.empty(M, dtype=torch.int32, device=dev)
                           for _ in range(3))
    n_bad = torch.zeros(1, dtype=torch.int32, device=dev)
    if M == 0:
        return head, dist, tail_of, n_bad
    lib = _load()
    slots = torch.empty(lib.contract_slot_rows() * lib.contract_slots(M),
                        dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.contract_rank_launch(
            chain_next.data_ptr(), M, head.data_ptr(), dist.data_ptr(),
            tail_of.data_ptr(), slots.data_ptr(), n_bad.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _launched("ranking", rc)
    return head, dist, tail_of, n_bad


def revcomp_cuda(hi: torch.Tensor, lo: torch.Tensor, k: int):
    """K9's reverse complements of the node words (``revcomp_packed``) ->
    (rhi, rlo) int64[Np]."""
    _cuda_args(hi, lo, dtype=torch.int64, n=hi.numel())
    rhi, rlo = torch.empty_like(hi), torch.empty_like(lo)
    if hi.numel() == 0:
        return rhi, rlo
    with torch.cuda.device(hi.device):
        rc = _load().contract_revcomp_launch(
            hi.data_ptr(), lo.data_ptr(), hi.numel(), k, rhi.data_ptr(),
            rlo.data_ptr(), torch.cuda.current_stream(hi.device).cuda_stream)
    _launched("revcomp", rc)
    return rhi, rlo


def keep_cuda(head, tail_of, hi, lo, rhi, rlo) -> torch.Tensor:
    """K9's keep rule from the ranking's head and tail_of -> keep bool[M]."""
    n = hi.numel()
    _cuda_args(hi, lo, rhi, rlo, dtype=torch.int64, n=n)
    _cuda_args(head, tail_of, dtype=torch.int32, n=2 * n)
    keep = torch.empty(head.numel(), dtype=torch.bool, device=head.device)
    if hi.numel() == 0:
        return keep
    with torch.cuda.device(hi.device):
        rc = _load().contract_keep_launch(
            hi.data_ptr(), lo.data_ptr(), rhi.data_ptr(), rlo.data_ptr(),
            hi.numel(), head.data_ptr(), tail_of.data_ptr(), keep.data_ptr(),
            torch.cuda.current_stream(hi.device).cuda_stream)
    _launched("keep rule", rc)
    return keep


def contract_cuda(chain_next, hi, lo, k: int):
    """Launch K9 on chain_next's GPU and current stream (module docstring)."""
    check(chain_next, hi, lo, k)
    head, dist, tail_of, n_bad = rank_cuda(chain_next)
    rhi, rlo = revcomp_cuda(hi, lo, k)
    keep = keep_cuda(head, tail_of, hi, lo, rhi, rlo)
    return head, dist, keep, rhi, rlo, n_bad


def contract(chain_next, hi, lo, k: int):
    """K9 for CUDA tensors, its plain version for CPU tensors."""
    fn = contract_cuda if chain_next.is_cuda else contract_plain
    return fn(chain_next, hi, lo, k)


def count_bad(chain_next: torch.Tensor) -> int:
    """Chain targets out of range or shared by two nodes (K9's n_bad)."""
    M = chain_next.numel()
    t = chain_next[chain_next >= 0].long()
    out = t >= M
    shared = torch.bincount(t[~out], minlength=M).clamp(min=1) - 1
    return int(out.sum()) + int(shared.sum())


def keep_rule_plain(head, is_tail, hi, lo, rhi, rlo) -> torch.Tensor:
    """Torch mirror of ``_path_summary_np``: keep the oriented path whose
    head k-mer is <= (unsigned) its mirror path's head k-mer."""
    M = head.numel()
    idx = torch.arange(M, device=head.device)
    tail_of = torch.zeros(M, dtype=torch.int64, device=head.device)
    tail_of[head[is_tail].long()] = idx[is_tail]
    is_head = head.long() == idx

    def obits(a):
        i, o = a >> 1, (a & 1) == 1
        return (torch.where(o, rhi[i], hi[i]), torch.where(o, rlo[i], lo[i]))

    h_hi, h_lo = obits(idx)
    m_hi, m_lo = obits(tail_of ^ 1)
    return is_head & (kp.ult(h_hi, m_hi) |
                      ((h_hi == m_hi) & ~kp.ult(m_lo, h_lo)))


def contract_plain(chain_next, hi, lo, k: int):
    """Pure-torch twin of K9 on any device: the pointer-jumping
    contraction, the reverse complements and the keep rule."""
    from ..models import contiger  # the models import the ops

    check(chain_next, hi, lo, k)
    n_bad = count_bad(chain_next)
    if n_bad:
        raise ValueError(f"{n_bad} chain targets out of range or shared")
    head, dist, is_tail = contiger.contract_paths(chain_next)
    rhi, rlo = kp.revcomp_packed(hi, lo, k)
    keep = keep_rule_plain(head, is_tail, hi, lo, rhi, rlo)
    return (head, dist, keep, rhi, rlo,
            torch.zeros(1, dtype=torch.int32, device=chain_next.device))
