"""compare_contigs — contig-set comparison tool.

The reference ships an unfinished, build-disabled stub
(src/compare_contigs.cpp:73-75; src/CMakeLists.txt:23-24).  This is the
completed equivalent: compares two contig/unitig FASTAs strand-insensitively
and reports set overlap, k-mer-level agreement, and length statistics —
the checks the BASELINE parity configs call for.
"""

from __future__ import annotations

import argparse
import sys

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


def kmer_set(seqs: list[str], k: int) -> set[str]:
    out = set()
    for s in seqs:
        for i in range(len(s) - k + 1):
            km = s[i : i + k]
            if "N" not in km:
                out.add(dna.canonical(km))
    return out


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

    ka = kmer_set(sa, args.k)
    kb = kmer_set(sb, args.k)
    kinter = ka & kb

    stats_a = contig_stats([Unitig(s, 0) for s in sa])
    stats_b = contig_stats([Unitig(s, 0) for s in sb])

    print(f"contigs: {len(ca)} vs {len(cb)}; identical: {len(inter)} "
          f"({len(inter) / max(len(ca | cb), 1):.4f} jaccard)")
    print(f"{args.k}-mers: {len(ka)} vs {len(kb)}; shared: {len(kinter)} "
          f"({len(kinter) / max(len(ka | kb), 1):.4f} jaccard)")
    print(f"A: total={stats_a['total_len']} N50={stats_a['N50']} "
          f"max={stats_a['max_len']}")
    print(f"B: total={stats_b['total_len']} N50={stats_b['N50']} "
          f"max={stats_b['max_len']}")
    return 0 if ca == cb else 1


if __name__ == "__main__":
    sys.exit(main())
