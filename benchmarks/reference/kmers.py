"""k-mer arithmetic of the plain reference, in plain PyTorch on int64.

Written for this benchmark from the published definitions; it shares no
code with the program under test.

ntHash (Mohamadi et al. 2016; the four 64-bit seeds are the published
constants) of a k-mer s of bases s_0..s_{k-1}:

  fh(s) = XOR_i rol(S[s_i], (k-1-i) mod 64)
  rh(s) = XOR_i rol(S[3-s_i], i mod 64)
  key(s) = min(fh, rh) mod 2^key_bits      (unsigned minimum)

A k-mer (33 <= k <= 63) is held as two words: ``hi`` the first k-32 bases
and ``lo`` the last 32, two bits a base (A=0, C=1, G=2, T=3), first base
highest, so (hi, lo) compared unsigned is the order of the strings.

``bits=32`` is the control: the same hash computed in 32-bit words (the
seeds' low halves, rotations mod 32), the step down from the 64-bit hash
that the configuration states.
"""

from __future__ import annotations

import torch

SEEDS64 = (0x3C8BFBB395C60474, 0x3193C18562A02B4C, 0x20323ED082572324,
           0x295549F54BE24456)
SIGN = -(1 << 63)


def _i64(v: int) -> int:
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >> 63 else v


def seeds(bits: int, device) -> torch.Tensor:
    m = (1 << bits) - 1
    return torch.tensor([_i64(s & m) for s in SEEDS64], dtype=torch.int64,
                        device=device)


def shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 words."""
    if s == 0:
        return x
    if s >= 64:
        return torch.zeros_like(x)
    return (x >> s) & ((1 << (64 - s)) - 1)


def rol(x: torch.Tensor, r, bits: int = 64) -> torch.Tensor:
    """Rotate left by r (an int or an int64 tensor) within ``bits``."""
    m = -1 if bits == 64 else (1 << bits) - 1
    if isinstance(r, int):
        r %= bits
        if r == 0:
            return x
        return ((x << r) | shr(x & m, bits - r)) & m
    r = r % bits
    left = (x << r) & m
    right = torch.where(r == 0, torch.zeros_like(x),
                        _shr_t(x & m, (bits - r) % bits))
    return left | right


def _shr_t(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Logical right shift by a tensor of amounts in [1, 63]."""
    mask = torch.bitwise_left_shift(torch.ones_like(x), 64 - s) - 1
    return torch.bitwise_right_shift(x, s) & mask


def umin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned minimum of int64 words."""
    return torch.where((a ^ SIGN) < (b ^ SIGN), a, b)


def ulex_less(ah, al, bh, bl) -> torch.Tensor:
    """(ah, al) < (bh, bl), words compared unsigned."""
    ah, bh, al, bl = ah ^ SIGN, bh ^ SIGN, al ^ SIGN, bl ^ SIGN
    return (ah < bh) | ((ah == bh) & (al < bl))


def window_hashes(codes: torch.Tensor, k: int, bits: int = 64):
    """(fh, rh) of every k-window of each row of ``codes`` (uint8 [n, L]),
    each [n, L-k+1] int64, by the closed form of the prefix XORs:
    fh(i) = rol(P[i+k] ^ P[i], k-1+i) with P the prefix XOR of
    rol(S[s_j], -j), and rh(i) = rol(Q[i+k] ^ Q[i], -i) with Q that of
    rol(S[3-s_j], j)."""
    n, L = codes.shape
    dev = codes.device
    S = seeds(bits, dev)
    c = codes.long()
    j = torch.arange(L, device=dev, dtype=torch.int64)
    a = rol(S[c], (-j) % bits, bits)
    b = rol(S[3 - c], j % bits, bits)
    P = torch.zeros((n, L + 1), dtype=torch.int64, device=dev)
    Q = torch.zeros((n, L + 1), dtype=torch.int64, device=dev)
    P[:, 1:] = _xor_scan(a)
    Q[:, 1:] = _xor_scan(b)
    W = L - k + 1
    i = torch.arange(W, device=dev, dtype=torch.int64)
    fh = rol(P[:, k:] ^ P[:, :W], (i + k - 1) % bits, bits)
    rh = rol(Q[:, k:] ^ Q[:, :W], (-i) % bits, bits)
    return fh, rh


def _xor_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix XOR along the last axis (Hillis-Steele)."""
    out = x.clone()
    s = 1
    while s < x.shape[-1]:
        nxt = out.clone()
        nxt[..., s:] ^= out[..., :-s]
        out = nxt
        s *= 2
    return out


def key_of(fh: torch.Tensor, rh: torch.Tensor, key_bits: int) -> torch.Tensor:
    return umin(fh, rh) & ((1 << key_bits) - 1)


# -- hashes of neighbours, rolled from a k-mer's own (fh, rh) --------------

def succ_hash(fh, rh, first, x, k: int, bits: int = 64):
    """(fh, rh) of s[1:] + x, from s's hashes and first base."""
    S = seeds(bits, fh.device)
    nfh = rol(fh, 1, bits) ^ rol(S[first], k, bits) ^ S[x]
    nrh = rol(rh, bits - 1, bits) ^ rol(S[3 - first], bits - 1, bits) \
        ^ rol(S[3 - x], k - 1, bits)
    return nfh, nrh


def sibling_hash(fh, rh, first, x, k: int, bits: int = 64):
    """(fh, rh) of x + s[1:]."""
    S = seeds(bits, fh.device)
    return (fh ^ rol(S[first], k - 1, bits) ^ rol(S[x], k - 1, bits),
            rh ^ S[3 - first] ^ S[3 - x])


# -- two-word k-mers --------------------------------------------------------

def pack_windows(codes: torch.Tensor, k: int):
    """(hi, lo) of every k-window of each row: [n, L-k+1] each."""
    if not 33 <= k <= 63:
        raise ValueError(f"k={k}: the reference holds 33 <= k <= 63")
    n, L = codes.shape
    W = L - k + 1
    c = codes.long()
    hi = torch.zeros((n, W), dtype=torch.int64, device=codes.device)
    lo = torch.zeros((n, W), dtype=torch.int64, device=codes.device)
    for t in range(k - 32):
        hi = (hi << 2) | c[:, t:t + W]
    for t in range(k - 32, k):
        lo = (lo << 2) | c[:, t:t + W]
    return hi, lo


def first_base(hi, k: int):
    return shr(hi, 2 * (k - 33)) & 3


def last_base(lo):
    return lo & 3


def shift_in(hi, lo, x, k: int):
    """s[1:] + x."""
    hm = (1 << (2 * (k - 32))) - 1
    nhi = ((hi << 2) | (shr(lo, 62) & 3)) & hm
    return nhi, (lo << 2) | x


def set_first(hi, x, k: int):
    """x + s[1:] (the ``lo`` word is unchanged)."""
    sh = 2 * (k - 33)
    return (hi & ~(3 << sh)) | (x << sh)


def _rev2(x: torch.Tensor) -> torch.Tensor:
    """Reverse the 32 two-bit groups of a 64-bit word."""
    for s, m in ((2, 0x3333333333333333), (4, 0x0F0F0F0F0F0F0F0F),
                 (8, 0x00FF00FF00FF00FF), (16, 0x0000FFFF0000FFFF)):
        x = (shr(x, s) & m) | ((x & m) << s)
    return (shr(x, 32)) | (x << 32)


def revcomp(hi, lo, k: int):
    """Reverse complement of (hi, lo)."""
    s = 128 - 2 * k  # the 128-bit reversal leaves the k-mer s bits high
    H, L = _rev2(lo), _rev2(hi)
    nlo = shr(L, s) | (H << (64 - s))
    nhi = shr(H, s)
    hm = (1 << (2 * (k - 32))) - 1
    return nhi ^ hm, ~nlo


def canonical(hi, lo, k: int):
    """(hi, lo, flipped): the lesser of the k-mer and its reverse
    complement, and whether that is the reverse complement."""
    rh, rl = revcomp(hi, lo, k)
    flip = ulex_less(rh, rl, hi, lo)
    return torch.where(flip, rh, hi), torch.where(flip, rl, lo), flip


def lexsort_pairs(hi, lo, *prefix):
    """Permutation sorting by (prefix..., hi, lo unsigned), stable."""
    perm = torch.argsort(lo ^ SIGN, stable=True)
    perm = perm[torch.argsort(hi[perm], stable=True)]
    for p in reversed(prefix):
        perm = perm[torch.argsort(p[perm], stable=True)]
    return perm


def find_rows(shi, slo, qhi, qlo) -> torch.Tensor:
    """Row of each query (qhi, qlo) in the sorted distinct table (shi, slo),
    -1 where absent: a merge of the two by a stable sort."""
    ns = shi.numel()
    tag = torch.cat([torch.zeros(ns, dtype=torch.int64, device=shi.device),
                     torch.ones(qhi.numel(), dtype=torch.int64,
                                device=shi.device)])
    h = torch.cat([shi, qhi])
    lw = torch.cat([slo, qlo])
    perm = lexsort_pairs(h, lw)
    # stable sort keeps the table's row (tag 0) first in a run of equals
    hs, ls = h[perm], lw[perm]
    new = torch.ones_like(hs, dtype=torch.bool)
    new[1:] = (hs[1:] != hs[:-1]) | (ls[1:] != ls[:-1])
    run = torch.cumsum(new.long(), 0) - 1
    first = perm[new]
    row_of_run = torch.where(first < ns, first, torch.full_like(first, -1))
    out = torch.empty(h.numel(), dtype=torch.int64, device=shi.device)
    out[perm] = row_of_run[run]
    return out[ns:]
