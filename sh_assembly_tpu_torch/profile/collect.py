"""Profile the Contiger's node collection (``contiger.collect_nodes``).

    python -m sh_assembly_tpu_torch.profile.collect [--device cuda]

Counterpart of ``profile_collect.py``, at its geometry: k = 28, qb = 22, a
500 kbp random genome and 150,000 reads of 100 bp in batches of 8192
(``np.random.default_rng(0)``).  Counts the reads into a spectrum (insert
and merge a batch), then runs ``collect_nodes`` (abundance 2) under
``cProfile`` inside the ``contiger:collect nodes`` phase, and logs the node
count, the phase's wall and the top 25 entries by cumulative time.  On a
CUDA device it also gives the device share: the summed device time of
every kernel of one more call (``torch.profiler``) over that call's wall.
``--genome-len``, ``--reads`` and ``--batch`` cut the size for a CPU run,
whose times mean nothing.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import pstats
import sys
import time

import numpy as np
import torch

from ..cli.cqf_denoise import resolve_device
from ..io import fastq
from ..models import contiger
from ..ops import nthash, spectrum as sp
from ..utils import profiling
from ..utils.logging import log
from . import kernels

# The numbers of the last run() in this process, for callers of main().
LAST: dict = {}

K, QB, LR = 28, 22, 100


def make_batches(genome_len: int = 500_000, n_reads: int = 150_000,
                 batch: int = 8192) -> list[fastq.Batch]:
    """Reads of LR bp at random starts of a random genome, seed 0, in
    batches of ``batch`` rows (the last one padded)."""
    rng = np.random.default_rng(0)
    genome = rng.integers(0, 4, size=genome_len).astype(np.uint8)
    out = []
    for i in range(0, n_reads, batch):
        n = min(batch, n_reads - i)
        starts = rng.integers(0, genome_len - LR, size=n)
        codes = np.full((batch, LR), 5, np.uint8)
        codes[:n] = genome[starts[:, None] + np.arange(LR)]
        lengths = np.zeros(batch, np.int32)
        lengths[:n] = LR
        out.append(fastq.Batch(codes=codes, lengths=lengths, n_rows=n))
    return out


def build_spectrum(batches, device) -> sp.Spectrum:
    """The reads' spectrum: insert and merge a batch, as the script does."""
    kb = QB + 8
    spec = sp.make(1 << QB, 1 << 21, device)
    for b in batches:
        keys, valid = nthash.windowed_canonical(
            torch.from_numpy(b.codes).to(device),
            torch.from_numpy(b.lengths).to(device), K)
        spec = sp.insert(spec, torch.where(
            valid, nthash.mask_keys(keys, kb), -1).reshape(-1))
        spec = sp.merge(spec, kb)
    return spec


def run(device, genome_len: int = 500_000, n_reads: int = 150_000,
        batch: int = 8192) -> dict:
    batches = make_batches(genome_len, n_reads, batch)
    spec = build_spectrum(batches, device)
    log(f"spectrum ready: {spec.ndistinct} distinct keys")

    def collect():
        return contiger.collect_nodes(spec, iter(batches), K, QB + 8, 2)

    profiling.reset()
    pr = cProfile.Profile()
    with profiling.phase("contiger:collect nodes"):
        pr.enable()
        hi, _, _ = collect()
        pr.disable()
    wall = profiling.GLOBAL.stats["contiger:collect nodes"].seconds
    res = dict(nodes=int(hi.numel()), wall_s=wall)
    log(f"collect_nodes: {wall:.3f} s, {res['nodes']} nodes")
    out = io.StringIO()
    pstats.Stats(pr, stream=out).sort_stats("cumulative").print_stats(25)
    for line in out.getvalue().splitlines():
        log(line)
    if torch.device(device).type == "cuda":
        t0 = time.perf_counter()
        collect()
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        by_kernel = kernels.kernel_times(collect, reps=1)
        res["device_s"] = sum(by_kernel.values()) / 1e6
        res["device_share"] = res["device_s"] / call_s
        log(f"device share: {res['device_s']:.3f} s of kernels in a "
            f"{call_s:.3f} s call ({100 * res['device_share']:.1f} %); by "
            f"kernel (ms): " + ", ".join(
                f"{n} {us / 1e3:.1f}" for n, us in sorted(
                    by_kernel.items(), key=lambda kv: -kv[1])[:8]))
    else:
        log("device share: not measured (no CUDA device)")
    return res


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="profile.collect")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--genome-len", type=int, default=500_000)
    p.add_argument("--reads", type=int, default=150_000)
    p.add_argument("--batch", type=int, default=8192)
    args = p.parse_args(argv)
    LAST.clear()
    LAST.update(run(resolve_device(args.device), args.genome_len,
                    args.reads, args.batch))
    return 0


if __name__ == "__main__":
    sys.exit(main())
