"""Packed k-mer representation on the device: (hi, lo) int64 pairs.

Counterpart of ``sh_assembly_tpu/ops/kmerpack.py``.  K-mers (k <= 63) are
2-bit packed MSB-first into a 128-bit value held as two 64-bit words,
left-aligned at bit 127, so that unsigned comparison of (hi, lo) equals
lexicographic comparison of the base strings.  The words are int64 tensors
holding the unsigned bit patterns (``ops/bits`` rules): every right shift
is ``bits.srl`` and every order comparison goes through ``bits.flip``.
"""

from __future__ import annotations

import torch

from . import bits

_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F
_M8 = 0x00FF00FF00FF00FF
_M16 = 0x0000FFFF0000FFFF
_LOW62 = 0x3FFFFFFFFFFFFFFF


def _s64(v: int) -> int:
    """A 64-bit unsigned pattern as the int64 Python value with those bits."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >> 63 else v


def _low_mask(n: int) -> int:
    """(1 << n) - 1 as an int64 pattern, n in [0, 64]."""
    return _s64((1 << n) - 1)


def ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise unsigned a < b on 64-bit words."""
    return bits.flip(a) < bits.flip(b)


def pack_windows(codes: torch.Tensor, k: int):
    """Pack every k-window of a (B, L) code batch -> (hi, lo) int64[B, W].

    Shifts the k columns of each window in, one column per step (the JAX
    package's rolling lax.scan, unrolled over k).  Codes are taken mod 4:
    windows holding non-ACGT codes are NOT flagged here.
    """
    B, L = codes.shape
    W = L - k + 1
    c64 = codes.long() & 3
    hi = torch.zeros((B, W), dtype=torch.int64, device=codes.device)
    lo = torch.zeros_like(hi)
    for j in range(k):
        hi = (hi << 2) | bits.srl(lo, 62)
        lo = (lo << 2) | c64[:, j:j + W]
    return _left_align(hi, lo, k)


def _left_align(hi: torch.Tensor, lo: torch.Tensor, k: int):
    """Shift a right-aligned 2k-bit (hi, lo) pair to be left-aligned at bit
    127, masking off stale bits above 2k."""
    nbits = 2 * k
    if nbits <= 64:
        return (lo & _low_mask(nbits)) << (64 - nbits), torch.zeros_like(lo)
    sh = 128 - nbits  # 0..62
    hi = hi & _low_mask(nbits - 64)
    if sh == 0:
        return hi, lo
    return (hi << sh) | bits.srl(lo, 64 - sh), lo << sh


def _rev2_word(x: torch.Tensor) -> torch.Tensor:
    """Reverse the 32 2-bit groups of a 64-bit word (butterfly swaps)."""
    x = (bits.srl(x, 2) & _M2) | ((x & _M2) << 2)
    x = (bits.srl(x, 4) & _M4) | ((x & _M4) << 4)
    x = (bits.srl(x, 8) & _M8) | ((x & _M8) << 8)
    x = (bits.srl(x, 16) & _M16) | ((x & _M16) << 16)
    return bits.srl(x, 32) | (x << 32)


def revcomp_packed(hi: torch.Tensor, lo: torch.Tensor, k: int):
    """Reverse complement of left-aligned packed k-mers (A<->T, C<->G =
    2-bit complement ~code, groups reversed), re-left-aligned."""
    nbits = 2 * k
    rhi, rlo = _rev2_word(~lo), _rev2_word(~hi)
    sh = 128 - nbits
    if sh == 0:
        return rhi, rlo
    if sh < 64:
        return (rhi << sh) | bits.srl(rlo, 64 - sh), rlo << sh
    if sh == 64:
        return rlo, torch.zeros_like(rlo)
    return rlo << (sh - 64), torch.zeros_like(rlo)


def canonicalize(hi, lo, rhi, rlo):
    """Unsigned lexicographic min((hi,lo), (rhi,rlo)) + orientation flag
    (True = the reverse complement is the canonical one)."""
    flip = ult(rhi, hi) | ((rhi == hi) & ult(rlo, lo))
    return torch.where(flip, rhi, hi), torch.where(flip, rlo, lo), flip


def _base_word(base) -> torch.Tensor | int:
    if isinstance(base, torch.Tensor):
        return base.long() & 3
    return int(base) & 3


def shift_in_base(hi: torch.Tensor, lo: torch.Tensor, base, k: int):
    """Successor k-mer: drop the first base, append `base` (left-aligned)."""
    nbits = 2 * k
    b = _base_word(base)
    nhi = (hi << 2) | bits.srl(lo, 62)
    nlo = lo << 2
    if nbits <= 64:
        nhi = nhi | (b << (64 - nbits))
    else:
        nlo = nlo | (b << (128 - nbits))
    return nhi, nlo


def replace_first_base(hi: torch.Tensor, lo: torch.Tensor, base, k: int):
    """Sibling k-mer: replace base 0 (bits 126..127 of hi, left-aligned)."""
    b = _base_word(base)
    top = b << 62 if isinstance(b, torch.Tensor) else _s64(b << 62)
    return (hi & _LOW62) | top, lo


def first_base(hi: torch.Tensor, lo: torch.Tensor, k: int) -> torch.Tensor:
    return bits.srl(hi, 62).to(torch.uint8)


def last_base(hi: torch.Tensor, lo: torch.Tensor, k: int) -> torch.Tensor:
    nbits = 2 * k
    if nbits <= 64:
        return (bits.srl(hi, 64 - nbits) & 3).to(torch.uint8)
    return (bits.srl(lo, 128 - nbits) & 3).to(torch.uint8)


def base_at(hi: torch.Tensor, lo: torch.Tensor, j: int, k: int):
    """Base code at position j (0 = leftmost)."""
    bitpos = 126 - 2 * j
    if bitpos >= 64:
        return (bits.srl(hi, bitpos - 64) & 3).to(torch.uint8)
    return (bits.srl(lo, bitpos) & 3).to(torch.uint8)


def sort_pairs(hi: torch.Tensor, lo: torch.Tensor, *minor: torch.Tensor):
    """Permutation that sorts (hi, lo, *minor) lexicographically, hi and lo
    unsigned, minor keys (small non-negative ints) as given: stable sorts,
    minor key first, as lax.sort orders its operands."""
    perm = torch.arange(hi.shape[0], device=hi.device)
    for key in (*reversed(minor), bits.flip(lo), bits.flip(hi)):
        perm = perm[torch.sort(key[perm], stable=True).indices]
    return perm


def join2_check(N: int, Q: int) -> None:
    """Refuse the table and query sizes the JAX package's join2 refuses
    (its packed (run id, index + 1) words would overflow); both routes of
    ``join2`` call it."""
    B = max(N.bit_length() + 1, 2)  # bits for (match index + 1)
    if (Q + N).bit_length() + B > 63:
        raise ValueError("join2 packing overflow")


def join2(table_hi: torch.Tensor, table_lo: torch.Tensor,
          qhi: torch.Tensor, qlo: torch.Tensor) -> torch.Tensor:
    """Exact-match join of 128-bit queries against a (hi, lo) key table.

    Returns int32 per query: the table index holding the identical pair, or
    -1; where the table holds a pair more than once, the largest index (the
    sentinel pad rows), as in the JAX package.  Table order is irrelevant.
    CUDA tensors launch kernel K7 (``node_join_cuda``, a hash join), CPU
    tensors take ``join2_plain``.
    """
    if qhi.is_cuda:
        from . import node_join_cuda

        return node_join_cuda.node_join(
            table_hi.contiguous(), table_lo.contiguous(), qhi.contiguous(),
            qlo.contiguous())
    return join2_plain(table_hi, table_lo, qhi, qlo)


def join2_plain(table_hi: torch.Tensor, table_lo: torch.Tensor,
                qhi: torch.Tensor, qlo: torch.Tensor) -> torch.Tensor:
    """``join2`` on any device: the JAX package's sort-join.

    One stable lexicographic sort groups each query with its table rows
    (table rows first, in index order: the concatenation is already in
    (tag, index) order), a cummax of (run id, row + 1) carries the largest
    row through the run, and a scatter restores query order.
    """
    N = table_hi.shape[0]
    Q = qhi.shape[0]
    join2_check(N, Q)
    B = max(N.bit_length() + 1, 2)  # bits for (match index + 1)
    dev = qhi.device
    h = torch.cat([table_hi, qhi])
    lo = torch.cat([table_lo, qlo])
    perm = sort_pairs(h, lo)
    sh, sl = h[perm], lo[perm]
    is_node = perm < N
    first = torch.ones(N + Q, dtype=torch.bool, device=dev)
    first[1:] = (sh[1:] != sh[:-1]) | (sl[1:] != sl[:-1])
    run_id = torch.cumsum(first.long(), 0)
    val = torch.where(is_node, perm + 1, 0)
    F = torch.cummax((run_id << B) | val, 0).values
    match = F & ((1 << B) - 1)
    out = torch.empty(Q, dtype=torch.int32, device=dev)
    isq = ~is_node
    out[perm[isq] - N] = (match[isq] - 1).to(torch.int32)
    return out
