"""sh-assembly — the full pipeline in one command, on a PyTorch device.

Runs the three reference stages back to back: CQF-deNoise counting ->
Contiger unitig graph -> Minia-style simplification, keeping the spectrum
on the device between stages (no .ser round-trip unless --save-cqf is
given).  Same flags as ``sh_assembly_tpu.cli.pipeline``, plus ``--device``
(default ``cuda``; asking for CUDA without a visible GPU is an error).

Usage example:
  python -m sh_assembly_tpu_torch.cli.pipeline -k 47 -i ReadFiles.txt \
      -n 12000000 -N 240000000 -e 0.00234 --endDeNoise -o contigs.fa
"""

from __future__ import annotations

import argparse
import sys
import time

from .. import config as cfg
from ..formats import cqf_ser
from ..io import fastq, native
from ..models import contiger, counter, simplify_arrays
from ..ops import spectrum as sp
from ..utils import profiling
from ..utils.logging import log
from .cqf_denoise import resolve_device


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sh-assembly", description="reads -> contigs, end to end")
    p.add_argument("-k", type=int, required=True)
    p.add_argument("-i", "--input", type=str, required=True,
                   help="file listing read file names")
    p.add_argument("-f", "--format", type=str, default="auto",
                   choices=["g", "b", "f", "auto"])
    p.add_argument("-n", "--trueKmer", type=int, required=True)
    p.add_argument("-N", type=int, required=True, dest="total_kmers")
    p.add_argument("-e", "--alpha", type=float, default=-1.0)
    p.add_argument("--errorProfile", type=str, default="",
                   help="file with per-base error rates, one per line")
    p.add_argument("--fr", type=float, default=0.0)
    p.add_argument("-t", type=int, default=16, dest="threads",
                   help="host reader/decode threads")
    p.add_argument("--deNoise", type=int, default=-1)
    p.add_argument("--endDeNoise", action="store_true")
    p.add_argument("-s", "--abundance_min", type=int, default=2)
    p.add_argument("-o", "--output", type=str, default="contigs.fa")
    p.add_argument("--unitigs", type=str, default="unitigs.fa")
    p.add_argument("--save-cqf", type=str, default="")
    p.add_argument("--genome-size", type=int, default=0,
                   help="for NG50 reporting")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda)")
    return p


def main(argv: list[str] | None = None) -> int:
    args = make_parser().parse_args(argv)
    device = resolve_device(args.device)
    t0 = time.time()
    profiling.reset()
    with profiling.maybe_trace():
        rc = _run(args, device, t0)
    profiling.GLOBAL.log_report("pipeline phase breakdown")
    return rc


def _run(args, device, t0: float) -> int:
    error_profile = None
    if args.alpha == -1.0 and args.errorProfile:
        with open(args.errorProfile) as f:
            error_profile = [float(x) for x in f.read().split()]
    sizing = cfg.size_counter(
        k=args.k, n_true_kmers=args.trueKmer, total_kmers=args.total_kmers,
        alpha=args.alpha, error_profile=error_profile, fr=args.fr,
        num_deNoise=args.deNoise, end_deNoise=args.endDeNoise)
    files = fastq.read_file_list(args.input)

    log(f"[1/3] counting {args.k}-mers (qb={sizing.qb}, "
        f"deNoise={sizing.num_deNoise}) on {device}")
    spec, stats = counter.build_spectrum_from_files(
        files, sizing, fmode=args.format, n_threads=args.threads,
        device=device)
    log(f"counted {stats.kmers} k-mers, {stats.distinct} distinct "
        f"({stats.seconds:.1f}s)")
    if args.save_cqf:
        keys, counts, trav = sp.to_host(spec, sizing.hb)
        cqf_ser.write_ser(args.save_cqf, keys, counts, qb=sizing.qb,
                          key_bits=sizing.hb, nelts=stats.kmers,
                          ndistinct=stats.distinct)
        log(f"wrote {args.save_cqf}")

    log("[2/3] building unitig graph")
    params = cfg.ContigerParams(k=args.k, kmer_abundance_min=args.abundance_min)
    batch_cfg = cfg.BatchConfig()
    stream = native.packed_batches_from_files(
        files, args.k, args.format, batch_cfg.reads_per_batch,
        (batch_cfg.max_read_len + 7) // 8 * 8, n_threads=args.threads)
    arrays = contiger.assemble_unitigs_arrays(spec, stream, params,
                                              key_bits=sizing.hb)
    with profiling.phase("contiger:fasta dump"):
        arrays.write_fasta(args.unitigs)
    log(f"{arrays.n} unitigs -> {args.unitigs}")

    log("[3/3] simplifying graph")
    with profiling.phase("simplify"):
        codes, offs, cov, sstats = \
            simplify_arrays.simplify_to_contigs_arrays(arrays)
        with profiling.phase("simplify.write", sync=False):
            simplify_arrays.write_contigs_arrays(args.output, codes, offs,
                                                 cov)
    summary = simplify_arrays.contig_stats_arrays(
        offs, genome_size=args.genome_size or None)
    log(f"removed tips={sstats['tips']} bubbles={sstats['bubbles']} "
        f"ec={sstats['ec']}")
    log(f"contigs={summary['n_contigs']} total={summary['total_len']} "
        f"N50={summary['N50']}" + (
            f" NG50={summary['NG50']}" if "NG50" in summary else ""))
    log(f"wrote {args.output}; total {time.time() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
