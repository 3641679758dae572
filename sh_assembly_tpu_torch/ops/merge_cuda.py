"""Kernel K1: merge-dedup-compact of the counting store.

Replaces the TPU kernel ``sh_assembly_tpu/ops/merge_pallas.py:merge_planes``
with the hand-written CUDA kernel ``csrc/merge_dedup.cu`` (its header says
what bounds it on the card and what the design does about it: one pass over
the inputs with a decoupled look-back across tiles, the buffer's sentinel
tail left unmerged, the output's tail written only where it is dirty).

Contract of ``merge_dedup(main, buf, n_main, key_bits, drop_singletons,
capacity, out=None, out_dirty=None)``:
  main: int64 store, key-sorted (unsigned order), ``n_main`` live entries
        ``key << KSHIFT | traveled << CBITS | count`` (count >= 1).
  buf:  int64, sorted, entries ``key << KSHIFT`` (count field 0 = one
        buffered occurrence), sentinels (-1) allowed at its tail.
  out, out_dirty: an int64[capacity] tensor to write the result into (not
        ``main``), with the caller's promise that ``out[out_dirty:]`` is
        all sentinel already; only ``out[:max(n_live, out_dirty)]`` is
        written.  Without ``out`` the result is a fresh tensor whose whole
        tail is filled.
  Returns (out int64[capacity], n_live, n_dropped): the sorted store with
  one entry per key and a sentinel tail; n_live may exceed capacity (the
  entries past it are lost and ``spectrum.check_overflow_value`` raises);
  both counts are 0-dim int64 tensors on the device.

CUDA tensors launch the kernel, and any failure raises.  CPU tensors take
``merge_dedup_plain``, the pure-torch twin of the JAX package's XLA merge
(``spectrum._merge_xla_path`` / ``_dedup_pack_sort``); the twin also runs on
CUDA tensors when called by name, which is how the kernel is checked.
"""

from __future__ import annotations

import ctypes

import torch

from . import bits

# Kernel launches (incremented once per launch of the CUDA kernel only).
LAUNCHES = 0

_lib = None


def _geometry(key_bits: int):
    kshift = 64 - key_bits
    if kshift < 8:
        raise ValueError(f"key_bits {key_bits} leaves no payload room")
    cb = min(kshift, 32) - 1
    cap = min((1 << cb) - 2, 1 << 30)
    return kshift, cb, cap


def _load():
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("merge_dedup")
        lib.merge_dedup_scratch_words.restype = ctypes.c_longlong
        lib.merge_dedup_scratch_words.argtypes = [ctypes.c_longlong]
        lib.merge_dedup_launch.restype = ctypes.c_int
        lib.merge_dedup_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong,  # a, na
            ctypes.c_void_p, ctypes.c_longlong,  # b, nb
            ctypes.c_void_p, ctypes.c_longlong,  # out, out_cap
            ctypes.c_longlong,                   # out_dirty
            ctypes.c_void_p, ctypes.c_void_p,    # scratch, meta
            ctypes.c_int, ctypes.c_int,          # key_bits, drop
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


def _output(main: torch.Tensor, capacity: int, out, out_dirty):
    """The tensor a merge writes into and the extent of it that may hold
    something else than sentinels: the caller's, checked, or a fresh one."""
    if out is None:
        if out_dirty is not None:
            raise ValueError("out_dirty given without out")
        return torch.empty(capacity, dtype=torch.int64,
                           device=main.device), capacity
    _check(out, "out")
    if out.numel() != capacity or out.device != main.device:
        raise ValueError("out must hold capacity words on main's device")
    if out.data_ptr() == main.data_ptr():
        raise ValueError("out must not be the main store")
    if out_dirty is None or not 0 <= out_dirty <= capacity:
        raise ValueError(f"out_dirty {out_dirty} outside [0, capacity]")
    return out, out_dirty


def merge_dedup_cuda(main: torch.Tensor, buf: torch.Tensor, n_main: int,
                     key_bits: int, drop_singletons: bool, capacity: int,
                     out: torch.Tensor | None = None,
                     out_dirty: int | None = None):
    """Launch K1 on its tensors' GPU and current stream (module docstring)."""
    global LAUNCHES
    _geometry(key_bits)
    _check(main, "main")
    _check(buf, "buf")
    if not (main.is_cuda and buf.is_cuda and main.device == buf.device):
        raise ValueError("merge_dedup_cuda needs both inputs on one GPU")
    if not 0 <= n_main <= main.numel():
        raise ValueError(f"n_main {n_main} outside the main store")
    out, out_dirty = _output(main, capacity, out, out_dirty)
    lib = _load()
    dev = main.device
    # tile descriptors and co-ranks; the launch zeroes what it must
    scratch = torch.empty(lib.merge_dedup_scratch_words(n_main + buf.numel()),
                          dtype=torch.int64, device=dev)
    meta = torch.empty(2, dtype=torch.int64, device=dev)
    # the launcher sizes its grid for the current device: make it the
    # tensors' own
    with torch.cuda.device(dev):
        rc = lib.merge_dedup_launch(
            main.data_ptr(), n_main, buf.data_ptr(), buf.numel(),
            out.data_ptr(), capacity, out_dirty, scratch.data_ptr(),
            meta.data_ptr(), key_bits, int(bool(drop_singletons)),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"merge_dedup kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out, meta[0], meta[1]


def merge_dedup_plain(main: torch.Tensor, buf: torch.Tensor, n_main: int,
                      key_bits: int, drop_singletons: bool, capacity: int,
                      out: torch.Tensor | None = None,
                      out_dirty: int | None = None):
    """Pure-torch twin of K1 on any device.

    Follows the JAX package's XLA merge: one sort of the concatenation
    groups each key's run; an inclusive cumsum and a running max of the
    run-start prefixes give exact run totals at each run's last slot.  The
    survivors are already in key order, so a boolean compaction stands in
    for the XLA path's second sort (same output).
    """
    kshift, cb, cap = _geometry(key_bits)
    dev = main.device
    out, out_dirty = _output(main, capacity, out, out_dirty)
    packed = bits.usort(torch.cat([main[:n_main], buf]))
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    if packed.numel() == 0:
        out[:out_dirty] = bits.SENTINEL
        return out, zero, zero
    sent = packed == bits.SENTINEL
    # sentinels keep the all-ones key, so they never share a run with a
    # real max-key entry (key == 2^key_bits - 1 < 2^56)
    keys = torch.where(sent, bits.SENTINEL, bits.srl(packed, kshift))
    raw = packed & ((1 << cb) - 1)
    # count-0 convention: effective count = raw + (raw == 0)
    counts = torch.where(sent, 0, raw + (raw == 0).long())
    trav = torch.where(sent, 0, (packed >> cb) & 1)

    S = torch.cumsum(counts, 0)
    one = torch.ones(1, dtype=torch.bool, device=dev)
    first = torch.cat([one, keys[1:] != keys[:-1]])
    U = torch.cummax(torch.where(first, S - counts, -1), 0).values
    totals = S - U
    last = torch.cat([first[1:], one])

    keep = last & ~sent
    n_dropped = zero
    if drop_singletons:
        n_dropped = (keep & (totals < 2)).sum()
        keep = keep & (totals >= 2)
    tot_c = torch.clamp(totals, max=cap)
    surv = ((keys << kshift) | (trav << cb) | tot_c)[keep]
    n_live = surv.numel()
    m = min(n_live, capacity)
    out[:m] = surv[:m]
    out[m:out_dirty] = bits.SENTINEL
    return out, torch.tensor(n_live, dtype=torch.int64, device=dev), n_dropped


def merge_dedup(main: torch.Tensor, buf: torch.Tensor, n_main: int,
                key_bits: int, drop_singletons: bool, capacity: int,
                out: torch.Tensor | None = None,
                out_dirty: int | None = None):
    """K1 for CUDA tensors, its plain twin for CPU tensors."""
    fn = merge_dedup_cuda if main.is_cuda else merge_dedup_plain
    return fn(main, buf, n_main, key_bits, drop_singletons, capacity, out,
              out_dirty)
