"""Kernel K4: ascending unsigned sort of independent windows of u32 values.

Replaces the TPU kernel ``profile_blocksort.py:63 block_sort`` with the
hand-written CUDA kernel ``csrc/block_sort.cu`` (its header says what
bounds it on the card and how a window's bitonic network runs on chip: a
window of up to 2^17 values in the shared memory of a thread block cluster,
five stages in registers for every trip through shared memory; larger
windows add passes over device memory).

Contract of ``block_sort(x, W)``:
  x: a contiguous 1-D int32 tensor carrying u32 bit patterns (the
     ``ops/bits`` int-as-unsigned rule), of N = G * W values.
  W: the window, a power of two and a multiple of 128.
  Returns a new int32[N] tensor in which each of the G windows
  ``x[g * W:(g + 1) * W]`` is sorted ascending in UNSIGNED order; windows
  are not merged.  Keys carry no payload, so the result is unique.
  Raises on a W that is not a power of two or not a multiple of 128, on
  ``N % W != 0`` (the TPU version leaves the tail unwritten), on a wrong
  dtype and on a non-contiguous tensor.

CUDA tensors launch the kernel, and any failure raises.  CPU tensors take
``block_sort_plain`` (``torch.sort`` along the rows of ``x.view(G, W)``
with the top bit flipped); the plain version also runs on CUDA tensors
when called by name, which is how the kernel is checked and timed against
the one PyTorch call for the same function.
"""

from __future__ import annotations

import ctypes

import torch

from . import bits

LANES = 128  # the TPU kernel's lane width: W must be a multiple of it
MAX_W = 1 << 30

# Kernel launches (incremented once per launch of the CUDA kernel only).
LAUNCHES = 0

_lib = None


def _load():
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("block_sort")
        lib.block_sort_launch.restype = ctypes.c_int
        lib.block_sort_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,      # in, out
            ctypes.c_longlong, ctypes.c_longlong,  # N, W
            ctypes.c_void_p,                       # stream
        ]
        _lib = lib
    return _lib


def build() -> None:
    """Compile (if needed) and load the kernel library."""
    _load()


def _check(x: torch.Tensor, W: int) -> None:
    if x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError("x must be a contiguous 1-D int32 tensor (u32 bit "
                         "patterns)")
    if W < LANES or W & (W - 1) or W > MAX_W:
        raise ValueError(f"window {W} must be a power of two, a multiple of "
                         f"{LANES} and at most 2^30")
    if x.numel() % W:
        raise ValueError(f"{x.numel()} values are not a whole number of "
                         f"windows of {W}")


def block_sort_cuda(x: torch.Tensor, W: int) -> torch.Tensor:
    """Launch K4 on the current CUDA stream (see module docstring)."""
    global LAUNCHES
    _check(x, W)
    if not x.is_cuda:
        raise ValueError("block_sort_cuda needs a CUDA tensor")
    lib = _load()
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.block_sort_launch(x.data_ptr(), out.data_ptr(), x.numel(), W,
                               stream)
    if rc != 0:
        raise RuntimeError(f"block_sort kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out


def block_sort_plain(x: torch.Tensor, W: int) -> torch.Tensor:
    """Pure-torch K4 on any device: one ``torch.sort`` over the rows."""
    _check(x, W)
    rows = bits.flip32(x).view(-1, W)
    return bits.flip32(torch.sort(rows, dim=1).values).view(-1)


def block_sort(x: torch.Tensor, W: int) -> torch.Tensor:
    """K4 for CUDA tensors, its plain version for CPU tensors."""
    if x.is_cuda:
        return block_sort_cuda(x, W)
    return block_sort_plain(x, W)
