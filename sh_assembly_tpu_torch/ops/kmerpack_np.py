"""Host (numpy) mirror of ops.kmerpack: packed 128-bit k-mer arithmetic.

The Contiger's final host-assembly pass (models/contiger) operates on the
same left-aligned (hi, lo) uint64-pair representation the device uses, so
sequence materialization, mirror dedup, and link construction stay fully
vectorized instead of per-unitig Python string work (the reference does
this stage as multithreaded C++ passes, src/contig_assembly.cpp:277-629).
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


def shift_in_base(hi: np.ndarray, lo: np.ndarray, base: int, k: int):
    """Successor k-mer: drop the first base, append `base` (left-aligned)."""
    bits = 2 * k
    b = _u(int(base) & 3)
    nhi = (hi << _u(2)) | (lo >> _u(62))
    nlo = lo << _u(2)
    if bits <= 64:
        nhi = nhi | (b << _u(64 - bits))
    else:
        nlo = nlo | (b << _u(128 - bits))
    return nhi, nlo


def replace_first_base(hi: np.ndarray, lo: np.ndarray, base: int, k: int):
    """Sibling k-mer: replace base 0 (bits 126..127 of hi, left-aligned)."""
    b = _u(int(base) & 3)
    return (hi & _u(0x3FFFFFFFFFFFFFFF)) | (b << _u(62)), lo


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


def join(table_hi: np.ndarray, table_lo: np.ndarray,
         qhi: np.ndarray, qlo: np.ndarray) -> np.ndarray:
    """Exact-match join of 128-bit queries against a distinct-key table.

    Returns int64 per query: the table index holding the identical (hi, lo)
    pair, or -1.  One lexsort over the concatenation + a forward max-scan —
    the host analogue of ops.kmerpack.join2.
    """
    N = len(table_hi)
    Q = len(qhi)
    if Q == 0:
        return np.zeros(0, np.int64)
    assert (N + Q + 1) * (N + 1) < (1 << 63), "join scan packing overflow"
    h = np.concatenate([table_hi, qhi])
    l = np.concatenate([table_lo, qlo])
    # table rows first within an equal key so the scan sees them before
    # their queries
    tag = np.concatenate([np.zeros(N, np.uint8), np.ones(Q, np.uint8)])
    pay = np.concatenate([np.arange(N, dtype=np.int64),
                          np.arange(Q, dtype=np.int64)])
    order = np.lexsort((tag, l, h))
    sh, sl, st, sp_ = h[order], l[order], tag[order], pay[order]
    first = np.empty(N + Q, bool)
    first[0] = True
    first[1:] = (sh[1:] != sh[:-1]) | (sl[1:] != sl[:-1])
    run_id = np.cumsum(first)
    # carry (run_id, table_index+1) forward; queries read the carried index
    g = run_id * (N + 1) + np.where(st == 0, sp_ + 1, 0)
    F = np.maximum.accumulate(g)
    match = np.where(F // (N + 1) == run_id, F % (N + 1), 0)
    out = np.full(Q, -1, np.int64)
    isq = st == 1
    out[sp_[isq]] = match[isq] - 1
    return out
