"""Unsigned 64-bit arithmetic on int64 tensors.

PyTorch has no unsigned arithmetic beyond uint8: uint32/uint64 shifts,
comparisons and adds raise.  The port therefore carries every 64-bit word
(packed store entries, ntHash values) as int64 holding the same bit
pattern, under these rules:

  * ``<<`` on int64 wraps, which is already the unsigned result.
  * ``>>`` on int64 is arithmetic; a logical shift masks the high bits
    (``srl``).
  * Unsigned order is signed order after flipping the top bit
    (``flip``): every sort, comparison, min or searchsorted on a 64-bit
    word goes through it.  Without the flip half the keys order wrongly
    and the all-ones sentinel (-1) sorts first instead of last.
  * The empty-slot sentinel is all ones, i.e. -1.
  * Native uint64_t exists only inside CUDA kernels.
"""

from __future__ import annotations

import numpy as np
import torch

SENTINEL = -1  # all-ones 64-bit pattern
SIGN = -(1 << 63)  # the top bit as an int64 constant
SIGN32 = -(1 << 31)  # the top bit as an int32 constant


def flip(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving map from unsigned to signed order (an involution)."""
    return x ^ SIGN


def flip32(x: torch.Tensor) -> torch.Tensor:
    """``flip`` for int32 tensors that carry u32 bit patterns."""
    return x ^ SIGN32


def srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift by a constant s in [0, 63]."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (64 - s)) - 1)


def srl_t(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Logical right shift by per-element amounts s in [0, 63].

    (SIGN >> s) << 1 sets exactly the top s bits, so its complement keeps
    the 64 - s low bits the arithmetic shift produced.
    """
    top = (torch.full_like(s, SIGN) >> s) << 1
    return (x >> s) & ~top


def rol_t(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """64-bit rotate left by per-element amounts s in [0, 63]; the s == 0
    case needs no branch because x >>> (64 - s) is computed as
    (x >>> 1) >>> (63 - s)."""
    return (x << s) | srl_t(srl(x, 1), 63 - s)


def umin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise unsigned minimum."""
    return flip(torch.minimum(flip(a), flip(b)))


def usort(x: torch.Tensor) -> torch.Tensor:
    """Ascending unsigned sort of a 1-D int64 tensor (stable, as lax.sort
    is; the sentinel -1 sorts last)."""
    return flip(torch.sort(flip(x), stable=True).values)


def to_u64_np(x: torch.Tensor) -> np.ndarray:
    """int64 tensor -> numpy uint64 array with the same bit patterns."""
    return x.detach().cpu().numpy().view(np.uint64)


def from_u64_np(a: np.ndarray, device="cuda") -> torch.Tensor:
    """numpy uint64 array -> int64 tensor with the same bit patterns."""
    a = np.ascontiguousarray(a, dtype=np.uint64).view(np.int64)
    return torch.from_numpy(a.copy()).to(device)
