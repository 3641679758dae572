"""Kernel K7: the node join, the table index of 128-bit query pairs.

Replaces the JAX package's sort-join ``sh_assembly_tpu/ops/kmerpack.py:
join2``, which its ``jax.jit`` probe programs (``phantom_candidates``,
``build_oriented_graph``) and the mesh Contiger's node join call, with the
hand-written CUDA kernel ``csrc/node_join.cu``: a hash join, one kernel
building an open-addressing table of the rows at a load of at most one half
and one probing it, a thread a query (its header says what bounds it on the
card and what the design does about it).  ``kmerpack.join2`` routes CUDA
tensors here and CPU tensors to ``kmerpack.join2_plain``, the sort-join,
which this kernel is checked against on the card.

Contract of ``node_join(table_hi, table_lo, qhi, qlo)``:
  table_hi, table_lo: contiguous 1-D int64 tensors of N rows, the pairs in
        any order, duplicates allowed (any 128-bit value, the (-1, -1)
        sentinel too);
  qhi, qlo: contiguous 1-D int64 tensors of Q queries, on the same GPU.
  Returns int32[Q]: the largest row holding the query's pair, or -1.
  Refuses, as ``join2_plain`` does, the sizes ``kmerpack.join2_check``
  refuses.  Q = 0 returns an empty tensor with no launch.  The slot table
  (32 bytes a slot, the smallest power of two of at least 2N and
  MIN_SLOTS slots) is allocated for the call and released after it.
"""

from __future__ import annotations

import ctypes

import torch

from . import kmerpack as kp

# Kernel launches (incremented once per launch of the CUDA kernel only).
LAUNCHES = 0

MIN_SLOTS = 64
SLOT_WORDS = 4  # int64 words a slot: hi, lo, row

_lib = None


def _load():
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("node_join")
        lib.node_join_launch.restype = ctypes.c_int
        lib.node_join_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,  # table
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,  # queries
            ctypes.c_void_p, ctypes.c_longlong,                   # slots, m
            ctypes.c_void_p,                                      # out
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


def node_join(table_hi: torch.Tensor, table_lo: torch.Tensor,
              qhi: torch.Tensor, qlo: torch.Tensor) -> torch.Tensor:
    """Launch K7 on the table's GPU and current stream (module
    docstring)."""
    global LAUNCHES
    for name, t in (("table_hi", table_hi), ("table_lo", table_lo),
                    ("qhi", qhi), ("qlo", qlo)):
        if t.dtype != torch.int64 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int64 tensor")
        if not t.is_cuda or t.device != table_hi.device:
            raise ValueError(f"{name} is on {t.device}: node_join needs all "
                             f"four on one GPU")
    N, Q = table_hi.numel(), qhi.numel()
    if table_lo.numel() != N or qlo.numel() != Q:
        raise ValueError("hi and lo differ in length")
    kp.join2_check(N, Q)
    out = torch.empty(Q, dtype=torch.int32, device=qhi.device)
    if Q == 0:
        return out
    m = slots_for(N)
    slots = torch.empty(SLOT_WORDS * m, dtype=torch.int64,
                        device=qhi.device)
    lib = _load()
    with torch.cuda.device(qhi.device):
        rc = lib.node_join_launch(
            table_hi.data_ptr(), table_lo.data_ptr(), N, qhi.data_ptr(),
            qlo.data_ptr(), Q, slots.data_ptr(), m, out.data_ptr(),
            torch.cuda.current_stream(qhi.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"node_join kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out
