"""Kernel K2: counts of sorted query keys against the sorted spectrum.

Replaces the TPU kernel ``sh_assembly_tpu/ops/join_pallas.py:
count_join_planes`` with the hand-written CUDA kernel ``csrc/count_join.cu``
(its header says what bounds it on the card and what the design does about
it: a partition kernel bounds every tile of queries in the live store, and
each tile streams its short store range through shared memory, or searches
device memory inside its range where the range is too wide to fit).

Contract of ``count_join(store, n_main, queries, key_bits)``:
  store:   int64 packed spectrum words ``key << KSHIFT | traveled << CBITS
           | count``, key-sorted (unsigned order), ``n_main`` live entries.
  queries: int64 raw keys (< 2^key_bits), ascending, -1 allowed at the
           tail.
  Returns int32[len(queries)]: the count field of the store entry with the
  query's key (the traveled bit is not part of it), 0 where no live entry
  has that key, 0 for -1 queries.

CUDA tensors launch the kernel, and any failure raises.  CPU tensors take
``count_join_plain`` (a binary search of the store's key column with
``torch.searchsorted``), which is also ``spectrum.query_join``'s body and
which the kernel is checked against on the card.
"""

from __future__ import annotations

import ctypes

import torch

from . import bits
from .merge_cuda import _geometry  # (KSHIFT, CBITS, count cap) of a word

# Kernel launches (incremented once per launch of the CUDA kernel only).
LAUNCHES = 0

_lib = None


def _load():
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("count_join")
        lib.count_join_scratch_words.restype = ctypes.c_longlong
        lib.count_join_scratch_words.argtypes = [ctypes.c_longlong]
        lib.count_join_launch.restype = ctypes.c_int
        lib.count_join_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong,  # store, n_main
            ctypes.c_void_p, ctypes.c_longlong,  # queries, nq
            ctypes.c_void_p, ctypes.c_void_p,    # out, scratch
            ctypes.c_int,                        # key_bits
            ctypes.c_void_p,                     # stream
        ]
        _lib = lib
    return _lib


def build() -> None:
    """Compile (if needed) and load the kernel library."""
    _load()


def _check(t: torch.Tensor, name: str) -> None:
    if t.dtype != torch.int64 or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D int64 tensor")


def count_join_cuda(store: torch.Tensor, n_main: int, queries: torch.Tensor,
                    key_bits: int) -> torch.Tensor:
    """Launch K2 on its tensors' GPU and current stream (module docstring)."""
    global LAUNCHES
    _geometry(key_bits)
    _check(store, "store")
    _check(queries, "queries")
    if not (store.is_cuda and queries.is_cuda
            and store.device == queries.device):
        raise ValueError("count_join_cuda needs both inputs on one GPU")
    if not 0 <= n_main <= store.numel():
        raise ValueError(f"n_main {n_main} outside the store")
    lib = _load()
    nq = queries.numel()
    out = torch.empty(nq, dtype=torch.int32, device=store.device)
    # the partition array: one store position per tile boundary
    scratch = torch.empty(lib.count_join_scratch_words(nq),
                          dtype=torch.int64, device=store.device)
    with torch.cuda.device(store.device):  # launch on the tensors' device
        rc = lib.count_join_launch(
            store.data_ptr(), n_main, queries.data_ptr(), nq, out.data_ptr(),
            scratch.data_ptr(), key_bits,
            torch.cuda.current_stream(store.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"count_join kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out


def count_join_plain(store: torch.Tensor, n_main: int, queries: torch.Tensor,
                     key_bits: int) -> torch.Tensor:
    """Pure-torch K2 on any device; query order is free here.

    The live store's key column (``packed >>> KSHIFT``, non-negative and
    strictly ascending) is binary-searched for each query.  Only the live
    prefix is searched: the sentinel's key part equals the maximum key
    2^key_bits - 1, so searching it would answer that key from a sentinel.
    """
    kshift, cb, _ = _geometry(key_bits)
    q = queries.reshape(-1)
    if n_main == 0:
        return torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    live = store[:n_main]
    skeys = bits.srl(live, kshift)
    valid = q != bits.SENTINEL
    qk = torch.where(valid, q, 0)
    at = torch.searchsorted(skeys, qk).clamp_(max=n_main - 1)
    hit = valid & (skeys[at] == qk)
    return torch.where(hit, live[at] & ((1 << cb) - 1), 0).to(torch.int32)


def count_join(store: torch.Tensor, n_main: int, queries: torch.Tensor,
               key_bits: int) -> torch.Tensor:
    """K2 for CUDA tensors, its plain version for CPU tensors."""
    if store.is_cuda:
        return count_join_cuda(store, n_main, queries, key_bits)
    return count_join_plain(store, n_main, queries, key_bits)
