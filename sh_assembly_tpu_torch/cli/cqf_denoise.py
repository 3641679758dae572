"""CQF-deNoise CLI — flag-compatible with the reference binary.

Counts canonical k-mers of the listed read files into the device spectrum,
runs the deNoise schedule, and serializes a reference-format .ser file.
Same flags as ``sh_assembly_tpu.cli.cqf_denoise``, plus ``--device``
(default ``cuda``; asking for CUDA without a visible GPU is an error,
never a silent CPU run).  ``--mesh N`` counts over N key-range shards on
that device (``parallel/driver.count_sharded``; -1: one a visible device
of its kind).

Usage example:
  python -m sh_assembly_tpu_torch.cli.cqf_denoise -k 47 -N 16506371070 \
      -n 119157843 -e 0.00234 -i ReadFiles.txt -o k47.cqf
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from .. import config as cfg
from ..formats import cqf_ser
from ..io import fastq
from ..models import counter
from ..ops import spectrum as sp
from ..utils import profiling
from ..utils.logging import current_datetime, log


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="CQF-deNoise",
        description="GPU k-mer counting with deNoise sweeps",
    )
    p.add_argument("-k", type=int, required=True, dest="k", help="k-mer size")
    p.add_argument("-n", "--trueKmer", type=int, required=True,
                   help="number of unique true k-mers")
    p.add_argument("-N", type=int, required=True, dest="total_kmers",
                   help="total number of k-mers")
    p.add_argument("-e", "--alpha", type=float, default=-1.0,
                   help="average base error rate (overrides errorProfile)")
    p.add_argument("--errorProfile", type=str, default="",
                   help="file with per-base error rates, one per line")
    p.add_argument("--fr", type=float, default=0.0,
                   help="tolerable rate of true k-mers wrongly removed"
                        " (default 1/trueKmer)")
    p.add_argument("--deNoise", type=int, default=-1,
                   help="number of deNoise rounds (overrides fr)")
    p.add_argument("--endDeNoise", action="store_true",
                   help="deNoise once more after processing all k-mers")
    p.add_argument("-t", type=int, default=16, dest="threads",
                   help="host reader/decode threads; reference default 16")
    p.add_argument("-f", "--format", type=str, default="f",
                   choices=["g", "b", "f"], help="g(zip) b(zip2) f(astq)")
    p.add_argument("-i", "--input", type=str, required=True,
                   help="file listing read file names")
    p.add_argument("-o", "--output", type=str, default="",
                   help="output .ser file name")
    p.add_argument("--mesh", type=int, default=0,
                   help="count over N key-range shards (0 = single store, "
                        "-1 = one a visible device)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to count on (default cuda)")
    return p


def resolve_device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name} was asked for but no CUDA GPU is visible; "
            "pass --device cpu to count on the CPU")
    return dev


def counter_sizing(args, error_profile=None) -> cfg.CounterSizing:
    """The counter's sizing from the parsed flags."""
    return cfg.size_counter(
        k=args.k,
        n_true_kmers=args.trueKmer,
        total_kmers=args.total_kmers,
        alpha=args.alpha,
        error_profile=error_profile,
        fr=args.fr,
        num_deNoise=args.deNoise,
        end_deNoise=args.endDeNoise,
    )


def main(argv: list[str] | None = None) -> int:
    args = make_parser().parse_args(argv)
    device = resolve_device(args.device)

    error_profile = None
    if args.alpha == -1.0:
        if not args.errorProfile:
            print("either --alpha or --errorProfile is required", file=sys.stderr)
            return 2
        with open(args.errorProfile) as f:
            error_profile = [float(x) for x in f.read().split()]

    sizing = counter_sizing(args, error_profile)
    output = args.output or f"k{args.k}.t{args.threads}.s{sizing.qb}.ser"

    log("CQF-deNoise settings:")
    log(f"qb: {sizing.qb}  hb: {sizing.hb}  K: {sizing.k}")
    log(f"number of true k-mers: {sizing.n_true_kmers}")
    log(f"tolerable wrong removal rate: {sizing.fr}")
    log(f"number of deNoise rounds: {sizing.num_deNoise}")
    log(f"deNoise after processing all k-mers: {sizing.end_deNoise}")
    log(f"number of unique k-mers triggering deNoise: "
        f"{sizing.ndistinct_for_deNoise}")
    log(f"device: {device}")

    files = fastq.read_file_list(args.input)

    log(current_datetime())
    log("Start to build K-mer spectrum...")
    t0 = time.time()
    profiling.reset()
    with profiling.maybe_trace():
        if args.mesh:
            from ..parallel import driver

            _, _, keys, counts, mstats = driver.count_sharded(
                files, sizing, fmode=args.format,
                n_mesh=None if args.mesh < 0 else args.mesh,
                n_threads=args.threads, device=device)
            stats = counter.BuildStats(**mstats)
        else:
            spec, stats = counter.build_spectrum_from_files(
                files, sizing, fmode=args.format, progress_every=200,
                n_threads=args.threads, device=device,
            )
        with profiling.phase("count:serialize"):
            if not args.mesh:
                keys, counts = sp.to_host(spec, sizing.hb)[:2]
            cqf_ser.write_ser(
                output, keys, counts, qb=sizing.qb, key_bits=sizing.hb,
                nelts=stats.kmers, ndistinct=stats.distinct,
            )
    log("Finished building K-mer spectrum!")
    log(f"Time for building K-mer spectrum: {time.time() - t0:.1f} seconds.")
    log(f"kmers={stats.kmers} distinct={stats.distinct} "
        f"batches={stats.batches} merges={stats.merges} sweeps={stats.sweeps}")
    profiling.GLOBAL.log_report("CQF-deNoise phase breakdown")
    return 0


if __name__ == "__main__":
    sys.exit(main())
