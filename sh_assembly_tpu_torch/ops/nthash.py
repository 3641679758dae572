"""Windowed canonical ntHash on the device (PyTorch).

Counterpart of ``sh_assembly_tpu/ops/nthash.py``: instead of rolling one
base at a time (the reference's serial rolling hash), all window hashes of
a batch of reads come at once from prefix-XORs:

    a_j  = rol(seed(s_j), (-j) mod 64)        b_j = rol(cseed(s_j), j mod 64)
    P    = exclusive prefix-XOR of a          Q   = exclusive prefix-XOR of b
    fh(i)= rol(P[i+k] ^ P[i], (k-1+i) mod 64) rh(i)= rol(Q[i+k]^Q[i], (-i) mod 64)
    key  = min(fh, rh) mod 2^key_bits         (canonical)

The per-column rotated seeds are host tables selected by base code.  Words
are full int64 (``ops/bits``); torch has no cumulative XOR, so the prefix
scan is a log-step scan of shifted XORs.  Bit-identical to the JAX
package's ``windowed_canonical_planes`` (tests/test_torch_nthash.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils import nthash as _host
from . import bits


@functools.lru_cache(maxsize=16)
def _rot_tables_np(L: int):
    """Per-column tables A, B int64[6, L] (as uint64 bit patterns):
    A[b, j] = rol64(SEEDS[b], (-j) mod 64), B[b, j] = rol64(CSEEDS[b], j mod 64).
    Rows 4 (N) and 5 (pad) are zero."""
    j = np.arange(L, dtype=np.uint64)
    sa = (np.uint64(64) - (j & np.uint64(63))) & np.uint64(63)
    sb = j & np.uint64(63)
    A = _host.rol(np.asarray(_host.SEEDS)[:, None], sa[None, :])
    B = _host.rol(np.asarray(_host.CSEEDS)[:, None], sb[None, :])
    return A.view(np.int64), B.view(np.int64)


def _rot_tables(L: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    A, B = _rot_tables_np(L)
    return (torch.from_numpy(A.copy()).to(device),
            torch.from_numpy(B.copy()).to(device))


def prefix_xor(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix-XOR along dim 1 -> [B, L+1] with a zero column 0
    (Hillis-Steele: ceil(log2 L) shifted XORs)."""
    s = x
    d = 1
    while d < x.shape[1]:
        s = torch.cat([s[:, :d], s[:, d:] ^ s[:, :-d]], dim=1)
        d *= 2
    return torch.cat([torch.zeros_like(x[:, :1]), s], dim=1)


def windowed_canonical(codes: torch.Tensor, lengths: torch.Tensor, k: int):
    """Canonical hashes for every k-window of a batch of (sub-)reads.

    Args:
      codes: uint8[B, L] base codes (0..3 = ACGT, 4 = N, 5 = pad).
      lengths: int32[B] number of valid leading bases per row.
      k: k-mer size.

    Returns:
      keys:  int64[B, L-k+1] canonical hashes min(fh, rh) as uint64 bit
             patterns (no range mod).
      valid: bool[B, L-k+1] — window i is valid iff i + k <= length.
    """
    B, L = codes.shape
    W = L - k + 1
    dev = codes.device
    A, Bt = _rot_tables(L, dev)
    col = torch.arange(L, device=dev)
    c = codes.long()
    Pa = prefix_xor(A[c, col])
    Pb = prefix_xor(Bt[c, col])

    i = torch.arange(W, device=dev)
    fh = bits.rol_t(Pa[:, k:] ^ Pa[:, :W], (i + (k - 1)) % 64)
    rh = bits.rol_t(Pb[:, k:] ^ Pb[:, :W], (64 - i % 64) % 64)
    keys = bits.umin(fh, rh)

    valid = (i[None, :] + k) <= lengths.to(dev)[:, None]
    return keys, valid


def seed_table(device="cuda") -> torch.Tensor:
    """The 6-entry ntHash seed table (A, C, G, T, N, pad) as int64."""
    return torch.from_numpy(
        np.asarray(_host.SEEDS, np.uint64).view(np.int64).copy()).to(device)


def cseed_table(device="cuda") -> torch.Tensor:
    """The complement seed table, like seed_table."""
    return torch.from_numpy(
        np.asarray(_host.CSEEDS, np.uint64).view(np.int64).copy()).to(device)


def mask_keys(keys: torch.Tensor, key_bits: int) -> torch.Tensor:
    """key mod 2^key_bits (power-of-two hash range); key_bits <= 56 here,
    so the mask is a positive int64 and the result is non-negative."""
    return keys & ((1 << key_bits) - 1)
