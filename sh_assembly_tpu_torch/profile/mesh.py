"""Time the routed (sharded) counting scan beside the plain single-shard
scan at the same per-shard geometry.

    python -m sh_assembly_tpu_torch.profile.mesh [--device cuda] [--n 8]

Counterpart of ``bench_mesh.py``.  n key-range shards on one device
(``parallel/collectives.InProcess``) count S = 4 stacked batches of
rows_per_shard x n reads of 160 bp, k = 31, from a 2 Mbp random genome
(``np.random.default_rng(7)``): one call is the routed scan (hash, sort,
quota rows, all_to_all, append) and a merge on every shard.  The plain
scan hashes and appends one shard's rows into one store of the same
capacity and merges.  Logs both medians (CUDA events on a CUDA device),
keys/s, and the routing tax: the routed call's time over n plain calls
(1.0 when routing costs nothing; the in-process shards run one after
another, so n plain calls are what the routed call does besides
routing).  Checks that no key was dropped and that every window was
counted.  ``--log2-capacity`` and ``--rows-per-shard`` cut the size for
a CPU run, whose times mean nothing.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..cli.cqf_denoise import resolve_device
from ..ops import spectrum as sp
from ..parallel import sharded
from ..utils.logging import log
from ..utils.profiling import median_ms

# The numbers of the last run() in this process, for callers of main().
LAST: dict = {}

K, S, L = 31, 4, 160


def make_input(n_rows: int):
    """S x n_rows reads of L bp from a 2 Mbp genome, seed 7."""
    rng = np.random.default_rng(7)
    genome = rng.integers(0, 4, size=2_000_000).astype(np.uint8)
    starts = rng.integers(0, len(genome) - L, size=(S, n_rows))
    codes = genome[starts[..., None] + np.arange(L)]
    return codes, np.full((S, n_rows), L, np.int32)


def run(device, n: int = 8, log2_capacity: int = 22,
        rows_per_shard: int = 1024, reps: int = 6) -> dict:
    key_bits = log2_capacity + 8
    B = rows_per_shard * n
    W = L - K + 1
    codes, lengths = make_input(B)
    sc = sharded.ShardedCounter(
        mesh=sharded.make_mesh(n, device), k=K, key_bits=key_bits,
        local_capacity=1 << log2_capacity, local_buf_capacity=1 << 22)
    stack = sc.shard_batch(codes, lengths)
    specs = sc.init()

    def routed():
        nonlocal specs
        specs, dropped = sc.append_scan(specs, *stack)
        specs = sc.merge(specs)
        if sum(dropped):
            raise AssertionError(f"the routed scan dropped {sum(dropped)} "
                                 f"keys")

    routed()  # warm-up (builds the kernels); every window counted once
    if sc.stats(specs)[1] != S * B * W:
        raise AssertionError(f"counted {sc.stats(specs)[1]} k-mers of "
                             f"{S * B * W}")
    ms = median_ms(routed, reps, device)

    spec = sp.make(1 << log2_capacity, 1 << 22, device)
    rows = [(torch.from_numpy(codes[s, :rows_per_shard]).to(device),
             torch.from_numpy(lengths[s, :rows_per_shard]).to(device))
            for s in range(S)]

    def plain():
        nonlocal spec
        for c, ln in rows:
            spec = sp.insert(spec, sc._keys(c, ln))
        spec = sp.merge(spec, key_bits)

    plain()
    if int(spec.nelts) != S * rows_per_shard * W:
        raise AssertionError("the plain scan did not count every window")
    plain_ms = median_ms(plain, reps, device)
    keys = S * B * W
    tax = ms / (n * plain_ms)
    log(f"mesh({n} shards on {device}): routed scan + merge {ms:.3f} ms "
        f"({keys / ms / 1e3:.1f} M keys/s for {keys} keys)")
    log(f"single shard, same geometry: {plain_ms:.3f} ms "
        f"({keys // n / plain_ms / 1e3:.1f} M keys/s) -> routing tax "
        f"x{tax:.2f} (ideal 1.0)")
    return dict(n=n, keys=keys, ms=ms, plain_ms=plain_ms, tax=tax)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="profile.mesh")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--n", type=int, default=8)
    p.add_argument("--log2-capacity", type=int, default=22)
    p.add_argument("--rows-per-shard", type=int, default=1024)
    p.add_argument("--reps", type=int, default=6)
    args = p.parse_args(argv)
    LAST.clear()
    LAST.update(run(resolve_device(args.device), args.n, args.log2_capacity,
                    args.rows_per_shard, args.reps))
    return 0


if __name__ == "__main__":
    sys.exit(main())
