"""Graph-simplification CLI — the reference pipeline's step 3.

The reference calls a customized external Minia v3 (`./minia -kmer-size K
-unitig -in unitigs.fa`, README.md:133-139); this brings the simplification
in-framework with the same invocation shape.  Output defaults to
`<in>.contigs.fa` like Minia's `<prefix>.contigs.fa`.
"""

from __future__ import annotations

import argparse
import sys
import time

from ..models import simplify
from ..utils.logging import log


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="minia", description="Minia-style unitig graph simplification")
    p.add_argument("-kmer-size", type=int, required=True, dest="k")
    p.add_argument("-in", type=str, required=True, dest="input",
                   help="unitig FASTA with km:f:/L: annotations")
    p.add_argument("-unitig", action="store_true",
                   help="input is a unitig graph (always true here; kept for"
                        " flag parity)")
    p.add_argument("-out", type=str, default="", dest="output",
                   help="output contig FASTA (default <in>.contigs.fa)")
    p.add_argument("-no-tip-removal", action="store_true")
    p.add_argument("-no-bulge-removal", action="store_true")
    p.add_argument("-no-ec-removal", action="store_true")
    return p


def main(argv: list[str] | None = None) -> int:
    args = make_parser().parse_args(argv)
    out = args.output or (args.input.rsplit(".fa", 1)[0] + ".contigs.fa")
    t0 = time.time()

    log(f"[simplify] loading unitig graph from {args.input}")
    g = simplify.load_unitig_fasta(args.input, args.k)
    log(f"[simplify] {len(g.unitigs)} unitigs")

    from ..models import simplify_arrays

    sg = simplify_arrays.ArrayGraph.from_unitig_graph(g)
    stats = {"tips": 0, "bubbles": 0, "ec": 0, "rounds": 0}
    for _ in range(simplify.MAX_ROUNDS):
        t = 0 if args.no_tip_removal else sg.clip_tips()
        sg.compact()
        b = 0 if args.no_bulge_removal else sg.pop_bubbles()
        sg.compact()
        e = 0 if args.no_ec_removal else sg.remove_erroneous_connections()
        sg.compact()
        stats["tips"] += t
        stats["bubbles"] += b
        stats["ec"] += e
        stats["rounds"] += 1
        if t + b + e == 0:
            break
    codes, offs, cov = sg.contigs_arrays()

    simplify_arrays.write_contigs_arrays(out, codes, offs, cov)
    summary = simplify_arrays.contig_stats_arrays(offs)
    log(f"[simplify] removed tips={stats['tips']} bubbles={stats['bubbles']} "
        f"ec={stats['ec']} in {stats['rounds']} rounds")
    log(f"[simplify] contigs={summary['n_contigs']} total={summary['total_len']} "
        f"N50={summary['N50']} max={summary['max_len']}")
    log(f"[simplify] wrote {out} in {time.time() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
