"""compare_contigs — contig-set comparison tool.

The reference ships an unfinished, build-disabled stub
(src/compare_contigs.cpp:73-75; src/CMakeLists.txt:23-24).  This is the
completed equivalent: compares two contig/unitig FASTAs strand-insensitively
and reports set overlap, k-mer-level agreement, and length statistics —
the checks the BASELINE parity configs call for.  Same output as
``sh_assembly_tpu.cli.compare_contigs``; the k-mer sets are arrays of
packed words in numpy rather than Python sets of strings.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..models.simplify import contig_stats
from ..models.contiger import Unitig
from ..utils import dna


def read_fasta_seqs(path: str) -> list[str]:
    seqs, cur = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if cur:
                    seqs.append("".join(cur))
                    cur = []
            else:
                cur.append(line.upper())
    if cur:
        seqs.append("".join(cur))
    return seqs


def _words(c: np.ndarray, m: int) -> np.ndarray:
    """w[i] = the 2-bit codes c[i:i + m] as one word, first base highest
    (1 <= m <= 32), for every i with i + m <= len(c): words of 1, 2, 4, ...
    bases by doubling, then joined along the binary digits of m."""
    n = len(c)
    pw, p = {1: c}, 1
    while 2 * p <= m:
        w = pw[p]
        pw[2 * p] = (w[:len(w) - p] << np.uint64(2 * p)) | w[p:]
        p *= 2
    out, got = None, 0
    for p in sorted(pw, reverse=True):
        if got + p > m:
            continue
        w = pw[p]
        if out is None:
            out = w
        else:
            keep = n - got - p + 1
            out = (out[:keep] << np.uint64(2 * p)) | w[got:got + keep]
        got += p
    return out


def _grouped(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """An order of the rows (hi, lo) that puts equal rows next to each
    other: a sort of one 64-bit mix of the row, or, should two different
    rows mix to the same word, a sort of the rows themselves."""
    h = (hi * np.uint64(0x9E3779B97F4A7C15)) ^ lo
    order = np.argsort(h)
    h, hi, lo = h[order], hi[order], lo[order]
    if ((h[1:] == h[:-1]) & ((hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1]))).any():
        return np.lexsort((lo, hi))
    return order


def _repeats(rows: np.ndarray) -> np.ndarray:
    """For rows in a grouped order: whether each row equals the one before."""
    same = np.zeros(len(rows), bool)
    same[1:] = (rows[1:] == rows[:-1]).all(axis=1)
    return same


def canonical_kmers(seqs: list[str], k: int) -> np.ndarray:
    """The distinct canonical k-mers (1 <= k <= 64) of seqs, leaving out
    those with a base other than ACGT, as rows of (hi, lo) words in no
    particular order: the 2k bits of the k-mer, first base highest."""
    if not 1 <= k <= 64:
        raise ValueError(f"k = {k}: compare_contigs packs k-mers of 1 to 64 "
                         f"bases")
    codes = dna.encode("N".join(seqs))  # an N between sequences
    W = len(codes) - k + 1
    if W <= 0:
        return np.zeros((0, 2), np.uint64)
    bad = np.concatenate([[0], np.cumsum(codes >= 4)])
    ok = (bad[k:] - bad[:W]) == 0

    def windows(c):
        if k <= 32:
            return np.zeros(W, np.uint64), _words(c, k)
        return _words(c, k - 32)[:W], _words(c, 32)[k - 32:]

    c = (codes & 3).astype(np.uint64)
    hi, lo = windows(c)
    # window i of the reverse complement is window W-1-i of the reversed
    # complemented sequence
    rhi, rlo = (w[::-1] for w in windows((np.uint64(3) - c)[::-1]))
    flip = (rhi < hi) | ((rhi == hi) & (rlo < lo))
    hi, lo = np.where(flip, rhi, hi)[ok], np.where(flip, rlo, lo)[ok]
    rows = np.stack([hi, lo], axis=1)[_grouped(hi, lo)]
    return rows[~_repeats(rows)]


def shared_rows(a: np.ndarray, b: np.ndarray) -> int:
    """Rows in both of two arrays of distinct rows."""
    both = np.concatenate([a, b])
    return int(np.count_nonzero(
        _repeats(both[_grouped(both[:, 0], both[:, 1])])))


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="compare_contigs",
        description="compare two contig FASTAs (strand-insensitive)")
    p.add_argument("-k", type=int, default=31, help="k for k-mer agreement")
    p.add_argument("a", help="first FASTA")
    p.add_argument("b", help="second FASTA")
    args = p.parse_args(argv)

    sa = read_fasta_seqs(args.a)
    sb = read_fasta_seqs(args.b)
    ca = {dna.canonical(s) for s in sa}
    cb = {dna.canonical(s) for s in sb}
    inter = ca & cb

    ka = canonical_kmers(sa, args.k)
    kb = canonical_kmers(sb, args.k)
    shared = shared_rows(ka, kb)

    stats_a = contig_stats([Unitig(s, 0) for s in sa])
    stats_b = contig_stats([Unitig(s, 0) for s in sb])

    print(f"contigs: {len(ca)} vs {len(cb)}; identical: {len(inter)} "
          f"({len(inter) / max(len(ca | cb), 1):.4f} jaccard)")
    union = len(ka) + len(kb) - shared
    print(f"{args.k}-mers: {len(ka)} vs {len(kb)}; shared: {shared} "
          f"({shared / max(union, 1):.4f} jaccard)")
    print(f"A: total={stats_a['total_len']} N50={stats_a['N50']} "
          f"max={stats_a['max_len']}")
    print(f"B: total={stats_b['total_len']} N50={stats_b['N50']} "
          f"max={stats_b['max_len']}")
    return 0 if ca == cb else 1


if __name__ == "__main__":
    sys.exit(main())
