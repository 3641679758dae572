"""The link join of the host assembly on the card: kernel K7 joins the
kept paths' ends with their 16 probes a path.

The links step of ``models/contiger._finalize_host`` (the JAX package's
``_finalize_host``: a table of the paths' ends sorted by ``np.lexsort``
with the last write winning on a repeated key, then three numpy joins of
the after-, before- and sibling probes).  For each deduplicated path p,
in order, the table holds two rows: row 2p the reverse complement of its
last k-mer, worth -(p + 1), and row 2p + 1 its first k-mer, worth
+(p + 1).  K7 (``ops/node_join_cuda``) answers a probe with the largest
row holding its pair, which is the last write of that insertion order: a
palindromic unitig, whose two rows hold one pair, keeps its + entry.

Contract of ``links(fhi, flo, thi, tlo, rfhi, rflo, rthi, rtlo, k)``:
  fhi, flo: each path's first k-mer; thi, tlo: its last k-mer; rfhi,
        rflo and rthi, rtlo: their reverse complements; contiguous 1-D
        int64 tensors of P2 paths (left-aligned packed words,
        ``kmerpack``), on one device; 1 <= k <= 63.
  Returns (av4 int32[4, P2], bv4 int32[4, P2], sv8 int32[8, P2]): the
  signed path (id + 1) each probe finds, 0 where it finds none.  The
  after-probes are the last k-mer shifted on by base X = 0..3; the
  before-probes the first k-mer's reverse complement shifted on by X =
  3, 2, 1, 0; the siblings the last k-mer's and then the reversed first
  k-mer's first base replaced by X = 0..3.

``links`` dispatches: CUDA tensors take ``links_cuda`` (the table rows and
the 16 P2 probes formed on the card, one K7 build and one probe of all of
them; nothing synchronises), any other tensor the plain twin
``links_plain``, the same rows and probes joined by
``kmerpack.join2_plain`` (the sort-join, largest row), which also runs on
CUDA tensors when called by name (how the route is checked).
"""

from __future__ import annotations

import torch

from . import kmerpack as kp
from . import node_join_cuda

# Link joins through K7 (incremented once per ``links_cuda`` call: a table
# built and probed once).
LAUNCHES = 0

PROBES = 16  # a path's probes: 4 after, 4 before, 8 siblings


def check(fhi, flo, thi, tlo, rfhi, rflo, rthi, rtlo, k) -> None:
    """Refuse what ``links`` does not take (module docstring)."""
    P2 = fhi.numel()
    for name, t in (("fhi", fhi), ("flo", flo), ("thi", thi), ("tlo", tlo),
                    ("rfhi", rfhi), ("rflo", rflo), ("rthi", rthi),
                    ("rtlo", rtlo)):
        if t.dtype != torch.int64 or t.shape != (P2,) or \
                not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int64 tensor "
                             f"of {P2} entries")
        if t.device != fhi.device:
            raise ValueError(f"{name} is on {t.device}, fhi on {fhi.device}")
    if not 1 <= k <= 63:
        raise ValueError(f"k {k} outside [1, 63]")
    kp.join2_check(2 * P2, PROBES * P2)


def rows(fhi, flo, rthi, rtlo):
    """The link table: (hi, lo) int64[2 P2], row 2p the reverse complement
    of path p's last k-mer, row 2p + 1 its first k-mer."""
    return (torch.stack([rthi, fhi], 1).reshape(-1),
            torch.stack([rtlo, flo], 1).reshape(-1))


def probes(thi, tlo, rfhi, rflo, k):
    """The 16 probes of every path -> (hi, lo) int64[16 P2], probe-major
    (after X = 0..3, before X = 3..0, siblings of the last k-mer X =
    0..3, siblings of the reversed first k-mer X = 0..3)."""
    P2 = thi.numel()
    X = torch.arange(4, device=thi.device).view(4, 1)
    t, rf = (thi.view(1, P2), tlo.view(1, P2)), (rfhi.view(1, P2),
                                                  rflo.view(1, P2))
    parts = [kp.shift_in_base(*t, X, k), kp.shift_in_base(*rf, 3 - X, k),
             kp.replace_first_base(*t, X, k),
             kp.replace_first_base(*rf, X, k)]
    hi, lo = zip(*(torch.broadcast_tensors(h, l) for h, l in parts))
    return torch.cat(hi).reshape(-1), torch.cat(lo).reshape(-1)


def values(row: torch.Tensor, P2: int):
    """Rows found (int32[16 P2], -1 = none) -> (av4, bv4, sv8): row 2p is
    worth -(p + 1), row 2p + 1 +(p + 1), none 0."""
    id1 = (row >> 1) + 1
    v = torch.where(row < 0, 0, torch.where((row & 1) == 1, id1, -id1))
    v = v.to(torch.int32).view(PROBES, P2)
    return v[:4], v[4:8], v[8:]


def links_cuda(fhi, flo, thi, tlo, rfhi, rflo, rthi, rtlo, k: int):
    """The link join through K7 on fhi's GPU and current stream (module
    docstring): a table of 2 P2 rows built once and probed once."""
    global LAUNCHES
    check(fhi, flo, thi, tlo, rfhi, rflo, rthi, rtlo, k)
    if not fhi.is_cuda:
        raise ValueError("K7's link join needs its tensors on a GPU")
    P2 = fhi.numel()
    if P2 == 0:
        return links_plain(fhi, flo, thi, tlo, rfhi, rflo, rthi, rtlo, k)
    table = node_join_cuda.NodeTable().build(*rows(fhi, flo, rthi, rtlo))
    row = table.probe(*probes(thi, tlo, rfhi, rflo, k))
    LAUNCHES += 1
    return values(row, P2)


def links_plain(fhi, flo, thi, tlo, rfhi, rflo, rthi, rtlo, k: int):
    """The link join on any device: the same rows and probes through
    ``kmerpack.join2_plain``."""
    check(fhi, flo, thi, tlo, rfhi, rflo, rthi, rtlo, k)
    row = kp.join2_plain(*rows(fhi, flo, rthi, rtlo),
                         *probes(thi, tlo, rfhi, rflo, k))
    return values(row, fhi.numel())


def links(fhi, flo, thi, tlo, rfhi, rflo, rthi, rtlo, k: int):
    """K7 on CUDA tensors, the plain twin otherwise."""
    fn = links_cuda if fhi.is_cuda else links_plain
    return fn(fhi, flo, thi, tlo, rfhi, rflo, rthi, rtlo, k)
