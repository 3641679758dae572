"""A dry run of the whole mesh layer over n key-range shards.

Counterpart of ``__graft_entry__.dryrun_multichip``: one all-gather
counting step, a merge, a sweep and the summed stats; the routed scan and
a merge whose forced sweep must fire; the sharded Contiger on the step's
spectrum.  Raises if a stage produces nothing; returns what each counted.
The counting step's random rows come twice each, so that k-mers recur
and survive the sweep at any n.
"""

from __future__ import annotations

import numpy as np

from .. import config as cfg
from ..io import fastq
from . import sharded, sharded_contiger


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    k, qb = 31, 12
    B, L = 8 * n_devices, 64
    sc = sharded.ShardedCounter(
        mesh=sharded.make_mesh(n_devices, device), k=k, key_bits=qb + 8,
        local_capacity=4096, local_buf_capacity=8192)

    rng = np.random.default_rng(7)
    # random rows, each twice: every k-mer recurs, so the sweep keeps them
    # at any n (the JAX dry run's rows, all distinct, keep none at n = 2)
    half = rng.integers(0, 4, size=(B // 2, L)).astype(np.uint8)
    codes = np.concatenate([half, half])
    lengths = np.full(B, L, np.int32)
    specs = sc.step(sc.init(), *sc.shard_batch(codes, lengths))
    specs = sc.merge(specs)
    specs = sc.merge(specs, drop_singletons=True)
    nd, ne = sc.stats(specs)
    if ne <= 0:
        raise AssertionError("no k-mers counted in the dry run")

    # the routed scan, then a merge whose sweep a threshold of 1 forces
    S = 2
    stack = rng.integers(0, 4, size=(S, B, L)).astype(np.uint8)
    specs2, dropped = sc.append_scan(
        sc.init(), *sc.shard_batch(stack, np.full((S, B), L, np.int32)))
    if sum(dropped):
        raise AssertionError(f"the routed scan dropped {sum(dropped)} keys")
    specs2, rounds = sc.merge_sweep(specs2, 1, 1)
    if rounds != 0:
        raise AssertionError("the sweep did not fire")

    # every window is a node here, and canonical k-mers skew to low top
    # bits (owner 0 takes ~1.9x the mean at n = 8): a wider quota
    arrays = sharded_contiger.assemble_unitigs_sharded(
        sc, specs, [fastq.Batch(codes=codes, lengths=lengths, n_rows=B)],
        cfg.ContigerParams(k=k, kmer_abundance_min=1), quota_slack=4.0)
    if arrays.n <= 0:
        raise AssertionError("the sharded Contiger produced no unitigs")
    return dict(step_distinct=nd, step_kmers=ne,
                scan_kmers=sc.stats(specs2)[1], unitigs=arrays.n)
