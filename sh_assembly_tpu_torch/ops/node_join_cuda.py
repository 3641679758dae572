"""Kernel K7: the node join, the table index of 128-bit query pairs.

Replaces the JAX package's sort-join ``sh_assembly_tpu/ops/kmerpack.py:
join2``, which its ``jax.jit`` probe programs (``phantom_candidates``,
``build_oriented_graph``) and the mesh Contiger's node join call, with the
hand-written CUDA kernels of ``csrc/node_join.cu``: a hash join on a table
of 64-byte buckets of (fingerprint, row) slots at a load of at most one
half, one kernel inserting rows and one probing, a warp 32 queries (its
header says what bounds it on the card and what the design does about it).

``NodeTable`` owns the table and the store it indexes, so that one table
serves many probes: the Contiger builds it once from closure round 1's
padded store, inserts only the phantoms each later round appends, and
probes it again for the graph.  ``node_join`` is a table that lives for
one call (a build and a probe); ``kmerpack.join2`` routes CUDA tensors
there and CPU tensors to ``kmerpack.join2_plain``, the sort-join.  A
table of CPU tensors answers with ``join2_plain`` over the rows it holds:
the plain version, which the kernels are checked against on the card.

Contract of ``node_join(table_hi, table_lo, qhi, qlo)`` and of a probe:
  table_hi, table_lo: contiguous 1-D int64 tensors of N rows, the pairs in
        any order, duplicates allowed (any 128-bit value, the (-1, -1)
        sentinel too);
  qhi, qlo: contiguous 1-D int64 tensors of Q queries, on the same device.
  Returns int32[Q]: the largest row holding the query's pair, or -1.
  Refuses, as ``join2_plain`` does, the sizes ``kmerpack.join2_check``
  refuses.  Q = 0 returns an empty tensor with no launch.  The table's
  slots (8 bytes each, the smallest power of two of at least 2N and
  MIN_SLOTS slots) and its row-major copy of the pairs (16 bytes a row)
  live as long as the table.
"""

from __future__ import annotations

import ctypes

import torch

from . import kmerpack as kp

# Kernel launches (incremented once per launch of a CUDA kernel only): all
# of K7's, and by kind (a build, an append, a probe).
LAUNCHES = 0
KINDS = {"build": 0, "append": 0, "probe": 0}

BUCKET = 8  # slots a bucket (64 bytes)
MIN_SLOTS = 64

_lib = None


def _load():
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("node_join")
        lib.node_table_insert.restype = ctypes.c_int
        lib.node_table_insert.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,  # table
            ctypes.c_longlong, ctypes.c_longlong,                 # r0, r1
            ctypes.c_longlong,                                    # tail
            ctypes.c_void_p, ctypes.c_longlong,                   # slots, nb
            ctypes.c_void_p, ctypes.c_int,                        # pairs
            ctypes.c_void_p,                                      # stream
        ]
        lib.node_table_probe.restype = ctypes.c_int
        lib.node_table_probe.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,  # queries
            ctypes.c_void_p, ctypes.c_longlong,                   # slots, nb
            ctypes.c_void_p, ctypes.c_void_p,                     # pairs, out
            ctypes.c_void_p,                                      # stream
        ]
        _lib = lib
    return _lib


def build() -> None:
    """Compile (if needed) and load the kernel library."""
    _load()


def slots_for(n: int) -> int:
    """Slots of the table for n rows: a power of two, at least 2n."""
    return max(MIN_SLOTS, 1 << max(2 * n - 1, 1).bit_length())


def _check(name: str, t: torch.Tensor, device) -> None:
    if t.dtype != torch.int64 or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D int64 tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the table on {device}")


def _launched(kind: str, rc: int, n: int = 1) -> None:
    global LAUNCHES
    if rc != 0:
        raise RuntimeError(f"node_join {kind} kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES += n
    KINDS[kind] += n


class NodeTable:
    """The node join's table over a store of N rows (hi, lo), built once
    and probed many times; rows may be appended in place of the store's
    sentinel tail.

    ``build(hi, lo, n_real)`` takes the store (no copy: the table owns it
    from then on, and ``append`` writes into it).  With ``n_real`` the
    caller promises that rows ``[n_real, N)`` hold the sentinel pair: the
    table then inserts the real rows and the pad's largest row alone, and
    accepts appends.  ``append(hi, lo, first_row)`` writes m new rows at
    ``first_row == n_real`` and inserts them; at least one pad row must
    remain (``first_row + m < N``), or the sentinel's answer would change:
    the caller rebuilds over a new extent instead.  ``probe(qhi, qlo)``
    answers as ``kmerpack.join2`` on the store as it stands.  CUDA tensors
    launch K7; CPU tensors take ``join2_plain`` (no table is built)."""

    def __init__(self):
        self.hi = self.lo = None
        self.n_real = None
        self._slots = self._pairs = None

    def build(self, hi: torch.Tensor, lo: torch.Tensor,
              n_real: int | None = None) -> "NodeTable":
        dev = hi.device
        _check("hi", hi, dev)
        _check("lo", lo, dev)
        N = hi.numel()
        if lo.numel() != N:
            raise ValueError("hi and lo differ in length")
        if n_real is not None and not 0 <= n_real <= N:
            raise ValueError(f"n_real {n_real} outside [0, {N}]")
        kp.join2_check(N, 0)
        self.hi, self.lo, self.n_real = hi, lo, n_real
        self._slots = self._pairs = None
        if not hi.is_cuda:
            return self
        m = slots_for(N)
        self._slots = torch.empty(m, dtype=torch.int64, device=dev)
        self._pairs = torch.empty(2 * N, dtype=torch.int64, device=dev)
        r1 = N if n_real is None else n_real
        tail = N - 1 if r1 < N else -1
        self._insert("build", 0, r1, tail, fill=1)
        return self

    def append(self, hi: torch.Tensor, lo: torch.Tensor,
               first_row: int) -> None:
        if self.n_real is None:
            raise ValueError("append needs a table built with n_real")
        m = hi.numel()
        N = self.hi.numel()
        if lo.numel() != m or first_row != self.n_real or \
                first_row + m >= N:
            raise ValueError(f"append of {m} rows at {first_row} to a table "
                             f"of {self.n_real} real rows in {N}: rows go "
                             f"after the real rows and leave a pad row")
        self.hi[first_row:first_row + m] = hi
        self.lo[first_row:first_row + m] = lo
        self.n_real = first_row + m
        if self._slots is not None and m:
            self._insert("append", first_row, first_row + m, -1, fill=0)

    def _insert(self, kind, r0, r1, tail, fill) -> None:
        dev = self.hi.device
        lib = _load()
        with torch.cuda.device(dev):
            rc = lib.node_table_insert(
                self.hi.data_ptr(), self.lo.data_ptr(), self.hi.numel(), r0,
                r1, tail, self._slots.data_ptr(),
                self._slots.numel() // BUCKET, self._pairs.data_ptr(), fill,
                torch.cuda.current_stream(dev).cuda_stream)
        # an empty store is a fill alone, no kernel
        _launched(kind, rc, int(r1 > r0 or tail >= 0))

    def probe(self, qhi: torch.Tensor, qlo: torch.Tensor) -> torch.Tensor:
        dev = self.hi.device
        _check("qhi", qhi, dev)
        _check("qlo", qlo, dev)
        Q = qhi.numel()
        if qlo.numel() != Q:
            raise ValueError("qhi and qlo differ in length")
        kp.join2_check(self.hi.numel(), Q)
        if self._slots is None:
            return kp.join2_plain(self.hi, self.lo, qhi, qlo)
        out = torch.empty(Q, dtype=torch.int32, device=dev)
        if Q == 0:
            return out
        lib = _load()
        with torch.cuda.device(dev):
            rc = lib.node_table_probe(
                qhi.data_ptr(), qlo.data_ptr(), Q, self._slots.data_ptr(),
                self._slots.numel() // BUCKET, self._pairs.data_ptr(),
                out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        _launched("probe", rc)
        return out

    def holds(self, hi: torch.Tensor, lo: torch.Tensor) -> bool:
        """True when (hi, lo) is the table's store itself."""
        return (self.hi is not None and hi.data_ptr() == self.hi.data_ptr()
                and lo.data_ptr() == self.lo.data_ptr()
                and hi.shape == self.hi.shape and lo.shape == self.lo.shape)


def node_join(table_hi: torch.Tensor, table_lo: torch.Tensor,
              qhi: torch.Tensor, qlo: torch.Tensor) -> torch.Tensor:
    """K7 on the table's GPU and current stream, a table that lives for
    this call: a build and a probe (module docstring)."""
    for name, t in (("table_hi", table_hi), ("table_lo", table_lo),
                    ("qhi", qhi), ("qlo", qlo)):
        if not t.is_cuda:
            raise ValueError(f"{name} is on {t.device}: node_join needs all "
                             f"four on one GPU")
        _check(name, t, table_hi.device)
    N, Q = table_hi.numel(), qhi.numel()
    if table_lo.numel() != N or qlo.numel() != Q:
        raise ValueError("hi and lo differ in length")
    kp.join2_check(N, Q)
    if Q == 0:
        return torch.empty(0, dtype=torch.int32, device=qhi.device)
    return NodeTable().build(table_hi, table_lo).probe(qhi, qlo)
