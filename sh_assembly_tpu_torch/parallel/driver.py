"""Mesh drivers: the counting and Contiger stages over n key-range shards.

Counterpart of ``sh_assembly_tpu/parallel/driver.py``, the entry the CLIs
call with ``--mesh N``; key-range sharding, sorted quota all_to_all
routing and the summed deNoise trigger are internal.  The drivers' mesh
is ``collectives.InProcess``: n shards on one device, one process.  Under
a process group of more than one they refuse to start, and a
multi-process job drives ``count_stream`` and
``sharded_contiger.shard_parts`` over ``multihost.make_global_mesh``.
"""

from __future__ import annotations

import time

import numpy as np

from .. import config as cfg
from ..io import fastq
from ..models import contiger
from ..ops import spectrum as sp
from ..utils import profiling
from ..utils.logging import log
from . import multihost, sharded, sharded_contiger


def _pow2_at_least(x: int, lo: int = 1) -> int:
    return 1 << max(int(np.ceil(np.log2(max(x, 1)))), int(np.log2(lo)))


def make_counter(sizing: cfg.CounterSizing, n_mesh: int | None,
                 batch_cfg: cfg.BatchConfig, super_batch: int = 4,
                 device="cuda") -> sharded.ShardedCounter:
    if multihost.rank_and_world()[1] > 1:
        raise ValueError(
            "the mesh drivers and the --mesh CLIs run in one process, and "
            "this one is in a process group of more than one (reference "
            "fault 10: the JAX driver builds the global mesh and then fails "
            "at its first scan); build the counter over "
            "multihost.make_global_mesh and drive count_stream in every "
            "process")
    mesh = sharded.make_mesh(n_mesh, device)
    n = mesh.n
    local_cap = _pow2_at_least(sizing.nslots // n, 1 << 12)
    # per-step routed block on a shard = local windows x quota slack (2.0,
    # append_scan's default).  One scan appends super_batch blocks with NO
    # merge between them, so the log buffer must hold a full stack plus
    # one more block of headroom
    windows_local = (batch_cfg.reads_per_batch // n) * (
        batch_cfg.max_read_len - sizing.k + 1)
    routed = int(np.ceil(windows_local / max(n, 1) * 2.0)) * n if n > 1 \
        else windows_local
    local_buf = _pow2_at_least(
        max((super_batch + 1) * routed + 1, 1 << 16))
    return sharded.ShardedCounter(
        mesh=mesh, k=sizing.k, key_bits=sizing.qb + 8,
        local_capacity=local_cap, local_buf_capacity=local_buf)


def count_stream(sc: sharded.ShardedCounter, batches,
                 sizing: cfg.CounterSizing, rows: int, L: int,
                 super_batch: int = 4):
    """The counting loop over this process's batches of ``rows`` x ``L``
    (every process of the mesh the same number of them:
    ``multihost.coordinated_stream``) -> (the spectra of the shards this
    process holds, stats dict).

    Appends stacks of S batches per routed scan (hash -> sorted quota
    all_to_all -> per-shard log append).  The host keeps the merge
    cadence: every scan appends S padded routed blocks whatever the stack
    holds, and the shards merge (and sweep, when the summed distinct count
    crosses the trigger) before a scan that would not fit.  Ends with the
    final merge, the trigger and the end-of-stream sweep.
    """
    S = super_batch
    specs = sc.init()
    rounds = int(sizing.num_deNoise)
    threshold = int(sizing.ndistinct_for_deNoise)

    t0 = time.time()
    stack_c = np.full((S, rows, L), 5, np.uint8)
    stack_l = np.zeros((S, rows), np.int32)
    fill = n_batches = dropped = merges = 0
    # every scan appends a fixed routed block per shard and step, so the
    # host knows each shard's fill without asking the device
    routed_step = sc.routed_per_step(rows // len(sc.mesh.shard_ids), L)
    BCl = sc.local_buf_capacity
    host_nbuf = 0

    if S * routed_step > BCl:
        raise ValueError(
            f"one fused scan appends {S * routed_step} buffer slots but "
            f"the shard log buffer holds {BCl}; raise local_buf_capacity "
            f"or lower super_batch")

    def merge_sweep(where: str):
        nonlocal specs, rounds, merges
        before = rounds
        specs, rounds = sc.merge_sweep(specs, rounds, threshold)
        merges += 1
        if rounds < before:
            log(f"[mesh] deNoise sweep {sizing.num_deNoise - rounds} "
                f"{where}: distinct={sc.stats(specs)[0]}")

    def flush():
        nonlocal fill, dropped, host_nbuf, specs, stack_c, stack_l
        # the padded stack always appends S blocks regardless of fill
        if host_nbuf + S * routed_step > BCl:
            with profiling.phase("count:mesh merge"):
                merge_sweep("mid-stream")
            host_nbuf = 0
        with profiling.phase("count:mesh scan"):
            specs, d = sc.append_scan(specs, *multihost.shard_host_batch(
                sc.mesh, stack_c, stack_l))
        host_nbuf += S * routed_step
        dropped += sum(d)
        stack_c = np.full((S, rows, L), 5, np.uint8)
        stack_l = np.zeros((S, rows), np.int32)
        fill = 0

    for b in batches:
        stack_c[fill] = b.codes
        stack_l[fill] = b.lengths
        fill += 1
        n_batches += 1
        if fill == S:
            flush()
    if fill:
        flush()
    dropped = sc.mesh.psum([dropped])  # agreed: every process raises
    if dropped:
        raise RuntimeError(
            f"sharded scan dropped {dropped} routed keys: raise quota_slack "
            f"or local_buf_capacity")

    # finalize merge + the trigger at the end of the stream: the merge
    # step itself checks the summed threshold and sweeps
    with profiling.phase("count:mesh finalize"):
        merge_sweep("at the end of the stream")
        sweeps = sizing.num_deNoise - rounds
        if sizing.end_deNoise:
            specs = sc.merge(specs, drop_singletons=True)
            sweeps += 1
        nd, ne = sc.stats(specs)
    log(f"[mesh] counted {ne} k-mers, {nd} distinct, {sweeps} sweeps, "
        f"{merges} merges, {n_batches} local batches in "
        f"{time.time() - t0:.1f}s")
    return specs, {"kmers": ne, "distinct": nd, "sweeps": sweeps,
                   "merges": merges, "batches": n_batches}


def count_sharded(
    files: list[str],
    sizing: cfg.CounterSizing,
    fmode: str = "auto",
    n_mesh: int | None = None,
    batch_cfg: cfg.BatchConfig | None = None,
    n_threads: int = 4,
    super_batch: int = 4,
    device="cuda",
):
    """Sharded counting over the mesh -> (counter, per-shard spectra,
    global keys, counts, stats dict): ``count_stream`` over the files'
    batches, then the gather.
    """
    batch_cfg = batch_cfg or cfg.BatchConfig()
    sc = make_counter(sizing, n_mesh, batch_cfg, super_batch=super_batch,
                      device=device)
    n = sc.n_shards
    log(f"[mesh] counting over {n} shards on {sc.device} "
        f"(local capacity 2^{int(np.log2(sc.local_capacity))}, "
        f"local buffer 2^{int(np.log2(sc.local_buf_capacity))})")
    B, L = batch_cfg.reads_per_batch, batch_cfg.max_read_len
    if B % n:
        raise ValueError(f"reads_per_batch {B} not divisible by mesh {n}")

    from ..io import native

    local = native.batches_from_files(
        multihost.partition_files(files), sizing.k, fmode, B, L,
        n_threads=n_threads)

    def empty_batch():
        return fastq.Batch(
            np.full((B, L), 5, np.uint8), np.zeros(B, np.int32), 0)

    specs, stats = count_stream(
        sc, multihost.coordinated_stream(local, sc.mesh, empty_batch),
        sizing, B, L, super_batch)
    with profiling.phase("count:mesh gather"):
        keys, counts = sc.gather_spectrum(specs)
    return sc, specs, keys, counts, stats


def contiger_sharded(
    sc: sharded.ShardedCounter,
    specs: list[sp.Spectrum],
    files: list[str],
    params: cfg.ContigerParams,
    fmode: str = "auto",
    batch_cfg: cfg.BatchConfig | None = None,
    n_threads: int = 4,
) -> contiger.ArrayUnitigs:
    """Sharded Contiger over the counting mesh's spectra."""
    batch_cfg = batch_cfg or cfg.BatchConfig()
    from ..io import native

    Lp = (batch_cfg.max_read_len + 7) // 8 * 8
    B = batch_cfg.reads_per_batch
    local = native.packed_batches_from_files(
        multihost.partition_files(files), params.k, fmode, B, Lp,
        n_threads=n_threads)

    def empty_batch():
        return fastq.PackedBatch(
            np.zeros((B, Lp // 4), np.uint8),
            np.full((B, Lp // 8), 0xFF, np.uint8),
            np.zeros(B, np.int32), 0)

    return sharded_contiger.assemble_unitigs_sharded(
        sc, specs, multihost.coordinated_stream(local, sc.mesh, empty_batch),
        params)
