"""Contiger CLI — flag-compatible with the reference binary.

Loads a .ser spectrum onto the device, streams the reads, builds the unitig
graph and writes the unitig FASTA with km:f:/L: link annotations.  Same
flags as ``sh_assembly_tpu.cli.contiger``, plus ``--device`` (default
``cuda``; asking for CUDA without a visible GPU is an error, never a silent
CPU run).  ``--mesh N`` builds the graph over N key-range shards on that
device (``parallel/driver.contiger_sharded``; -1: one a visible device of
its kind).

Usage example:
  python -m sh_assembly_tpu_torch.cli.contiger -k 47 -i ReadFiles.txt \
      -c k47.ser -o unitigs.fa --device cuda
"""

from __future__ import annotations

import argparse
import sys
import time

from .. import config as cfg
from ..formats import cqf_ser
from ..io import fastq, native
from ..models import contiger
from ..ops import spectrum as sp
from ..utils import profiling
from ..utils.logging import log
from .cqf_denoise import resolve_device


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="Contiger", description="GPU unitig graph construction")
    p.add_argument("-k", type=int, required=True, dest="k", help="k-mer size")
    p.add_argument("-i", "--input", type=str, required=True,
                   help="file listing read file names")
    p.add_argument("-f", "--format", type=str, default="f",
                   choices=["g", "b", "f"], help="g(zip) b(zip2) f(astq)")
    p.add_argument("-c", "--cqf", type=str, required=True,
                   help="counting quotient filter built with the same k")
    p.add_argument("-s", "--abundance_min", type=int, default=2,
                   help="min coverage of k-mers used to extend the assembly")
    p.add_argument("-x", "--solid_abundance_min", type=int, default=2,
                   help="min coverage of a solid k-mer to start the assembly")
    p.add_argument("-X", "--solid_abundance_max", type=int, default=1_000_000,
                   help="max coverage of a solid k-mer to start the assembly")
    p.add_argument("-t", type=int, default=16, dest="threads",
                   help="host reader/decode threads; reference default 16")
    p.add_argument("-o", "--output", type=str, default="unitigs.fa",
                   help="output unitig fasta")
    p.add_argument("--mesh", type=int, default=0,
                   help="build the graph over N key-range shards (0 = single "
                        "store, -1 = one a visible device)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to build the graph on (default cuda)")
    return p


def main(argv: list[str] | None = None) -> int:
    args = make_parser().parse_args(argv)
    device = resolve_device(args.device)
    t0 = time.time()

    log(f"[CQF] load cqf from disk: {args.cqf}")
    meta, keys, counts, traveled = cqf_ser.read_ser(args.cqf)
    if meta.seed != cqf_ser.DEFAULT_SEED:
        log(f"[warn] unexpected CQF seed {meta.seed}")
    log(f"[CQF] {len(keys)} distinct keys, qb={meta.qb} hb={meta.key_bits}")

    params = cfg.ContigerParams(
        k=args.k,
        kmer_abundance_min=args.abundance_min,
        solid_kmer_abundance_min=args.solid_abundance_min,
        solid_kmer_abundance_max=args.solid_abundance_max,
        output=args.output,
    )
    files = fastq.read_file_list(args.input)
    batch_cfg = cfg.BatchConfig()
    Lp = (batch_cfg.max_read_len + 7) // 8 * 8

    log("[Unitig] find unitigs")
    profiling.reset()
    with profiling.maybe_trace():
        if args.mesh:
            from ..parallel import driver

            sizing = cfg.CounterSizing(
                k=args.k, qb=meta.qb, hb=meta.key_bits, num_true_kmers=0,
                num_false_kmers=0, n_true_kmers=max(len(keys), 1),
                num_deNoise=0, ndistinct_for_deNoise=1 << 62,
                end_deNoise=False, fr=0.0)
            sc = driver.make_counter(
                sizing, None if args.mesh < 0 else args.mesh, batch_cfg,
                device=device)
            specs = sc.from_host(keys, counts.astype("int64"),
                                 traveled=traveled)
            arrays = driver.contiger_sharded(
                sc, specs, files, params, fmode=args.format,
                batch_cfg=batch_cfg, n_threads=args.threads)
        else:
            capacity = 1 << max(int(len(keys)).bit_length(), 10)
            spec = sp.from_host(keys, counts.astype("int64"), capacity,
                                buf_capacity=1 << 10, key_bits=meta.key_bits,
                                traveled=traveled, device=device)
            stream = native.packed_batches_from_files(
                files, args.k, args.format, batch_cfg.reads_per_batch, Lp,
                n_threads=args.threads)
            arrays = contiger.assemble_unitigs_arrays(
                spec, stream, params, key_bits=meta.key_bits)
        log(f"Number of unitigs: {arrays.n}")
        log(f"Number of palindrome unitigs: {arrays.n_palindromes}")
        log(f"Total length of unitigs: {int(arrays.offsets[-1])}")

        log("[Dump] save the unitig graph to file.")
        with profiling.phase("contiger:fasta dump"):
            arrays.write_fasta(args.output)
    profiling.GLOBAL.log_report("Contiger phase breakdown")
    log(f"Total time: {time.time() - t0:.1f} seconds.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
