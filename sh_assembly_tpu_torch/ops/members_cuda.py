"""Kernel K10: the members of the kept paths, placed on the card.

Replaces, where the contraction's forest lies on a CUDA device, the members
step of the host assembly (``models/contiger._members_host``, the first
lines of the JAX package's ``_finalize_host``): numpy's mask of the oriented
nodes down to the members of kept paths, its ``lexsort`` by (head, dist)
and its gathers of the oriented words, last bases and counts.  K9
(``ops/contract_cuda``) leaves head, dist and tail_of on the card, so the
order needs no sort: a path's members follow the exclusive scan of its
length over the heads, each at its head's offset plus its dist.  The
hand-written CUDA kernels of ``csrc/members.cu`` count, scan and place (its
header says what bounds them on the card and what the design does about
it), and only the member-ordered arrays cross to the host.

Contract of ``members(head, dist, tail_of, keep, hi, lo, rhi, rlo, real,
node_counts, k)``:
  head, dist, tail_of: contiguous 1-D int32 tensors of M = 2 Np oriented
        nodes, K9's ranking (tail_of read at kept heads only);
  keep: bool[M], K9's keep rule (true at heads only);
  hi, lo, rhi, rlo: int64[Np], the node words and their reverse
        complements; real: bool[Np], the live-node mask; node_counts:
        int32[Np]; all on one device; 1 <= k <= 63.
  Returns (ai int32[Mm], ohi int64[Mm], olo int64[Mm], lastb uint8[Mm],
  counts int32[Mm], starts int32[P], head_idx int32[P]): the Mm members of
  kept paths of real nodes in (head, dist) order with their oriented
  words, last bases (``kmerpack_np.last_base``) and counts; each path's
  first member and head, paths in the index order of their heads.  Bit for
  bit what ``_members_host`` gives.  A member whose path holds a padding
  row, or whose head is one, raises ValueError (``build_oriented_graph``
  gives padding rows no edge, so a forest of the Contiger never has one);
  so does a forest K9 did not rank.

CUDA tensors take ``members_cuda``: the count and the carry scan, a read of
the totals (the outputs' sizes; it synchronises), the offsets and the
placement, and a read of the members placed against the total.  CPU
tensors take ``members_plain``, a torch mirror that orders the members by a
stable sort of (head << 32) | dist; it also runs on CUDA tensors when
called by name, which is how the kernels are checked.
"""

from __future__ import annotations

import ctypes

import torch

from . import kmerpack as kp

# Placements run through the kernel library (incremented once per
# ``members_cuda`` call that launched: its count and its place entries).
LAUNCHES = 0

_lib = None

_P = ctypes.c_void_p


def _load():
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("members")
        lib.members_tiles.restype = ctypes.c_int
        lib.members_tiles.argtypes = [ctypes.c_int]
        lib.members_count_launch.restype = ctypes.c_int
        lib.members_count_launch.argtypes = [
            _P, _P, _P, _P, ctypes.c_int,  # keep, real, dist, tail_of, M
            _P, _P, _P, _P,                # bs, bf, tot, stream
        ]
        lib.members_place_launch.restype = ctypes.c_int
        lib.members_place_launch.argtypes = [
            _P, _P, _P, _P, _P, ctypes.c_int,  # keep .. tail_of, M
            _P, _P, _P, _P, _P,                # bs, bf, off, starts, head_idx
            _P, _P, _P, _P, _P,                # hi, lo, rhi, rlo, node_counts
            ctypes.c_int, ctypes.c_longlong,   # k, M_mem
            _P, _P, _P, _P, _P,                # ai, ohi, olo, lastb, counts
            _P, _P,                            # counters, stream
        ]
        _lib = lib
    return _lib


def build() -> None:
    """Compile (if needed) and load the kernel library."""
    _load()


def check(head, dist, tail_of, keep, hi, lo, rhi, rlo, real, node_counts,
          k) -> None:
    """Refuse what ``members`` does not take (module docstring)."""
    Np = hi.numel()
    want = [("head", head, torch.int32, 2 * Np),
            ("dist", dist, torch.int32, 2 * Np),
            ("tail_of", tail_of, torch.int32, 2 * Np),
            ("keep", keep, torch.bool, 2 * Np),
            ("hi", hi, torch.int64, Np), ("lo", lo, torch.int64, Np),
            ("rhi", rhi, torch.int64, Np), ("rlo", rlo, torch.int64, Np),
            ("real", real, torch.bool, Np),
            ("node_counts", node_counts, torch.int32, Np)]
    for name, t, dtype, n in want:
        if t.dtype != dtype or t.shape != (n,):
            raise ValueError(f"{name} must be a 1-D {dtype} tensor of {n} "
                             f"entries")
        if t.device != head.device:
            raise ValueError(f"{name} is on {t.device}, head on "
                             f"{head.device}")
    if 2 * Np >= 1 << 31:
        raise ValueError("int32 indices hold fewer than 2^31 oriented nodes")
    if not 1 <= k <= 63:
        raise ValueError(f"k {k} outside [1, 63]")


def _refuse(placed: int, total: int, bad: int) -> None:
    if bad or placed != total:
        raise ValueError(f"K10 placed {placed} members where the kept paths "
                         f"hold {total}, {bad} refused: a padding row on a "
                         f"kept path, or a forest K9 did not rank")


def _ptrs(*ts):
    return [t.data_ptr() for t in ts]


def count_cuda(keep, real, dist, tail_of):
    """K10's count and carry scan on keep's GPU and current stream ->
    (tot int64[2]: the members and the paths, bs, bf: the tiles' carries
    that ``place_cuda`` reads).  Nothing synchronises."""
    M, dev = keep.numel(), keep.device
    lib = _load()
    B = lib.members_tiles(M)
    bs = torch.empty(B, dtype=torch.int64, device=dev)
    bf = torch.empty(B, dtype=torch.int32, device=dev)
    tot = torch.empty(2, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = lib.members_count_launch(
            *_ptrs(keep, real, dist, tail_of), M, *_ptrs(bs, bf, tot),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"members count kernel launch failed: CUDA error "
                           f"{rc}")
    return tot, bs, bf


def place_cuda(head, dist, tail_of, keep, hi, lo, rhi, rlo, real,
               node_counts, k, bs, bf, n_members: int, n_paths: int):
    """K10's offsets and placement, the totals known (``count_cuda``) ->
    (the outputs of ``members``, counters int32[2]: the members placed and
    those refused).  Nothing synchronises."""
    M, dev = head.numel(), head.device

    def out(n, dtype):
        return torch.empty(n, dtype=dtype, device=dev)

    off = out(M, torch.int32)
    starts, head_idx = out(n_paths, torch.int32), out(n_paths, torch.int32)
    ai, counts = out(n_members, torch.int32), out(n_members, torch.int32)
    ohi, olo = out(n_members, torch.int64), out(n_members, torch.int64)
    lastb = out(n_members, torch.uint8)
    counters = out(2, torch.int32)
    with torch.cuda.device(dev):
        rc = _load().members_place_launch(
            *_ptrs(keep, real, head, dist, tail_of), M,
            *_ptrs(bs, bf, off, starts, head_idx, hi, lo, rhi, rlo,
                   node_counts), k, n_members,
            *_ptrs(ai, ohi, olo, lastb, counts, counters),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"members place kernel launch failed: CUDA error "
                           f"{rc}")
    return (ai, ohi, olo, lastb, counts, starts, head_idx), counters


def _cuda_args(*ts) -> None:
    for t in ts:
        if not t.is_cuda:
            raise ValueError("K10's launches need their tensors on a GPU")
        if not t.is_contiguous():
            raise ValueError("K10's tensors must be contiguous")


def members_cuda(head, dist, tail_of, keep, hi, lo, rhi, rlo, real,
                 node_counts, k: int):
    """Launch K10 on head's GPU and current stream (module docstring).  It
    synchronises twice: for the totals, which size the outputs, and for the
    members placed, which must equal them."""
    global LAUNCHES
    args = (head, dist, tail_of, keep, hi, lo, rhi, rlo, real, node_counts)
    check(*args, k)
    _cuda_args(*args)
    M = head.numel()
    if M == 0:
        return members_plain(*args, k)
    tot, bs, bf = count_cuda(keep, real, dist, tail_of)
    n_members, n_paths = tot.tolist()
    if not 0 <= n_members <= M:
        _refuse(0, n_members, 0)
    outs, counters = place_cuda(*args, k, bs, bf, n_members, n_paths)
    placed, bad = counters.tolist()
    LAUNCHES += 1
    _refuse(placed, n_members, bad)
    return outs


def tails(chain_next, head) -> torch.Tensor:
    """tail_of as K9's ranking leaves it at the heads, from the forest: a
    path's last node has no next, a cycle's the head as its next (-1 at
    every other node)."""
    idx = torch.arange(head.numel(), dtype=torch.int32, device=head.device)
    is_tail = (chain_next < 0) | (chain_next == head)
    tail_of = torch.full_like(head, -1)
    tail_of[head[is_tail].long()] = idx[is_tail]
    return tail_of


def members_plain(head, dist, tail_of, keep, hi, lo, rhi, rlo, real,
                  node_counts, k: int):
    """Pure-torch twin of K10 on any device: the same count and the same
    refusals, the members ordered by a stable sort of (head << 32) | dist."""
    check(head, dist, tail_of, keep, hi, lo, rhi, rlo, real, node_counts, k)
    M, dev = head.numel(), head.device
    hl, dl = head.long(), dist.long()
    if M and not bool(((hl >= 0) & (hl < M)).all()):
        _refuse(0, 0, int(((hl < 0) | (hl >= M)).sum()))
    real_o = real.repeat_interleave(2)  # real[a >> 1]
    # each kept head of a real node: dist[tail_of] + 1 members
    heads = torch.nonzero(keep & real_o).squeeze(1)
    t = tail_of[heads].long()
    t_ok = (t >= 0) & (t < M)
    cnt = torch.zeros(M, dtype=torch.int64, device=dev)
    cnt[heads[t_ok]] = (dl[t[t_ok]] + 1).clamp(min=0)
    heads = torch.nonzero(cnt > 0).squeeze(1)
    c = cnt[heads]
    starts = torch.cumsum(c, 0) - c
    n_members = int(c.sum())
    off = torch.full((M,), -1, dtype=torch.int64, device=dev)
    off[heads] = starts
    o = off[hl]
    in_path = o >= 0
    placed = in_path & real_o & (dl >= 0) & (o + dl < n_members)
    bad = (in_path & ~placed) | (~in_path & real_o & keep[hl])
    _refuse(int(placed.sum()), n_members, int(bad.sum()))
    a = torch.nonzero(placed).squeeze(1)
    a = a[torch.argsort((hl[a] << 32) | dl[a], stable=True)]
    n, odd = a >> 1, (a & 1) == 1
    ohi = torch.where(odd, rhi[n], hi[n])
    olo = torch.where(odd, rlo[n], lo[n])
    return (a.int(), ohi, olo, kp.last_base(ohi, olo, k), node_counts[n],
            starts.int(), heads.int())


def members(head, dist, tail_of, keep, hi, lo, rhi, rlo, real, node_counts,
            k: int):
    """K10 for CUDA tensors, its plain version for CPU tensors."""
    fn = members_cuda if head.is_cuda else members_plain
    return fn(head, dist, tail_of, keep, hi, lo, rhi, rlo, real, node_counts,
              k)
