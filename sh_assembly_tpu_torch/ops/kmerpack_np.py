"""Host (numpy) mirror of ops.kmerpack: packed 128-bit k-mer arithmetic.

The Contiger's host assembly (models/contiger) reads the same left-aligned
(hi, lo) uint64-pair representation the device uses, so sequence
materialization stays vectorized instead of per-unitig Python string work
(the reference does this stage as multithreaded C++ passes,
src/contig_assembly.cpp:277-629).
"""

from __future__ import annotations

import numpy as np

U64 = np.uint64
_FULL = U64(0xFFFFFFFFFFFFFFFF)


def _u(x: int) -> np.uint64:
    return U64(x)


def rev2_word(x: np.ndarray) -> np.ndarray:
    """Reverse the 32 2-bit groups of each uint64 (butterfly swaps)."""
    m2 = _u(0x3333333333333333)
    m4 = _u(0x0F0F0F0F0F0F0F0F)
    m8 = _u(0x00FF00FF00FF00FF)
    m16 = _u(0x0000FFFF0000FFFF)
    x = ((x >> _u(2)) & m2) | ((x & m2) << _u(2))
    x = ((x >> _u(4)) & m4) | ((x & m4) << _u(4))
    x = ((x >> _u(8)) & m8) | ((x & m8) << _u(8))
    x = ((x >> _u(16)) & m16) | ((x & m16) << _u(16))
    x = (x >> _u(32)) | (x << _u(32))
    return x


def revcomp_packed(hi: np.ndarray, lo: np.ndarray, k: int):
    """Reverse complement of left-aligned packed k-mers (numpy mirror of
    ops.kmerpack.revcomp_packed)."""
    bits = 2 * k
    rhi, rlo = rev2_word(~lo), rev2_word(~hi)
    sh = 128 - bits
    if sh == 0:
        return rhi, rlo
    if sh < 64:
        s = _u(sh)
        return (rhi << s) | (rlo >> _u(64 - sh)), rlo << s
    if sh == 64:
        return rlo, np.zeros_like(rlo)
    return rlo << _u(sh - 64), np.zeros_like(rlo)


def base_at(hi: np.ndarray, lo: np.ndarray, j: int, k: int) -> np.ndarray:
    """Base code at position j (0 = leftmost) of each packed k-mer."""
    bitpos = 126 - 2 * j
    if bitpos >= 64:
        return ((hi >> _u(bitpos - 64)) & _u(3)).astype(np.uint8)
    return ((lo >> _u(bitpos)) & _u(3)).astype(np.uint8)


def last_base(hi: np.ndarray, lo: np.ndarray, k: int) -> np.ndarray:
    bits = 2 * k
    if bits <= 64:
        return ((hi >> _u(64 - bits)) & _u(3)).astype(np.uint8)
    return ((lo >> _u(128 - bits)) & _u(3)).astype(np.uint8)
