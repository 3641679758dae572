"""The multi-process mesh on the CPU: two processes joined by gloo, each
holding two shards (``collectives.Distributed``, ``parallel/multihost``),
against the in-process mesh of four shards (``collectives.InProcess``)
and the JAX package's 4-device virtual mesh fed the same global batches:
every shard's whole counting state, the Contiger's stores and probe
parts, the unitig arrays finished from them, and the back end's calls.
Counterpart of ``tests/test_multiprocess.py`` and ``tests/mh_worker.py``.
Tolerance: exact.

The workers are ``_worker`` below, started by ``torch.multiprocessing``
with the spawn method; each imports this module, so the JAX package and
the oracle (which imports it) are imported inside the tests only, and the
workers run the port alone.  Each group has a timeout, and a worker that
outlives its join timeout is killed and fails the test.
"""

import datetime
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from sh_assembly_tpu_torch import config as cfg
from sh_assembly_tpu_torch.io import fastq, native
from sh_assembly_tpu_torch.ops import spectrum as sp
from sh_assembly_tpu_torch.parallel import collectives, driver, multihost, \
    sharded, sharded_contiger

DEV = "cpu"  # the port's functions default to the GPU
WORLD, LOCAL = 2, 2
N = WORLD * LOCAL
GROUP_TIMEOUT = 20  # seconds a collective waits for a peer
JOIN_TIMEOUT = 120  # seconds a test waits for its workers


# ---------------------------------------------------------------------------
# The worker and its tasks


def _states(mesh, specs) -> dict:
    """Every shard's whole state (``sp.to_jax_planes``), by global id."""
    out = {}
    for gid, spec in zip(mesh.shard_ids, specs):
        for f, v in sp.to_jax_planes(spec).items():
            out[f"s{gid}_{f}"] = v
    return out


def _task_count_scan(mesh, rank, reads, k, key_bits, rows_per_shard, L):
    """The JAX worker's run (tests/mh_worker.py): this process's partition
    of the reads in two batches, one fused scan of S = 2, a merge, the
    stats."""
    sc = sharded.ShardedCounter(mesh=mesh, k=k, key_bits=key_bits,
                                local_capacity=1 << 14,
                                local_buf_capacity=1 << 14)
    batcher = fastq.Batcher(k, rows_per_shard * len(mesh.shard_ids), L)
    batches = []
    for r in reads[rank::WORLD]:
        batches.extend(batcher.add_read(r))
    batches.extend(batcher.flush())
    assert len(batches) == 2, "one fused scan a process"
    codes = np.stack([b.codes for b in batches])
    lengths = np.stack([b.lengths for b in batches])
    specs, dropped = sc.append_scan(
        sc.init(), *multihost.shard_host_batch(mesh, codes, lengths))
    specs = sc.merge(specs)
    nd, ne = sc.stats(specs)
    live = [sp.to_host(s, key_bits) for s in specs]
    return dict(_states(mesh, specs), codes=codes, lengths=lengths,
                dropped=mesh.psum(dropped), nd=nd, ne=ne,
                keys=np.concatenate([x[0] for x in live]),
                counts=np.concatenate([x[1] for x in live]))


def _task_count_files(mesh, rank, files, sizing, rows, L, S, capacity,
                      buf_capacity):
    """``driver.count_stream`` over this process's share of the files."""
    sc = sharded.ShardedCounter(mesh=mesh, k=sizing.k,
                                key_bits=sizing.qb + 8,
                                local_capacity=capacity,
                                local_buf_capacity=buf_capacity)
    mine = multihost.partition_files(files)
    local = native.batches_from_files(mine, sizing.k, "auto", rows, L,
                                      n_threads=1)

    def empty():
        return fastq.Batch(np.full((rows, L), 5, np.uint8),
                           np.zeros(rows, np.int32), 0)

    specs, stats = driver.count_stream(
        sc, multihost.coordinated_stream(local, mesh, empty), sizing, rows,
        L, S)
    return dict(_states(mesh, specs), files=np.array(mine), **stats)


def _task_contig(mesh, rank, keys, counts, key_bits, capacity, batches,
                 params, node_cap_local):
    """The Contiger's collective steps on this process's rows of every
    global batch."""
    sc = sharded.ShardedCounter(mesh=mesh, k=params.k, key_bits=key_bits,
                                local_capacity=capacity,
                                local_buf_capacity=1 << 10)
    specs = sc.from_host(keys, counts)
    h = batches[0].codes.shape[0] // WORLD
    cut = slice(rank * h, (rank + 1) * h)
    mine = [fastq.Batch(b.codes[cut], b.lengths[cut], h, b.seed_col[cut])
            for b in batches]
    parts, saw = sharded_contiger.shard_parts(
        sc, specs, multihost.coordinated_stream(mine, mesh, None), params,
        node_cap_local=node_cap_local)
    out = dict(saw=saw)
    for gid, p in zip(mesh.shard_ids, parts):
        for f in sharded_contiger.ShardPart.__dataclass_fields__:
            out[f"s{gid}_{f}"] = getattr(p, f).numpy()
    return out


def _exchange_inputs(gid: int, n: int):
    """Shard gid's inputs to every call of the back end: parts of lengths
    that differ, int64 and uint8 rows [n, 3], an integer."""
    part = torch.arange(gid + 1, dtype=torch.int64) + 100 * gid
    rows = torch.arange(n * 3, dtype=torch.int64).reshape(n, 3) + 1000 * gid
    return part, rows, (rows % 251).to(torch.uint8), 7 * gid + 1


def _spread_keys():
    """Sorted keys of 20 bits over every shard's range, and counts."""
    keys = np.arange(5, 1 << 20, 37, dtype=np.uint64)
    return keys, np.full(len(keys), 3, np.int64)


def _task_exchange(mesh, rank, files):
    """Every call of the back end, and the single-process entry points'
    refusals."""
    ins = [_exchange_inputs(g, mesh.n) for g in mesh.shard_ids]
    out = dict(gather=mesh.all_gather([x[0] for x in ins]).numpy(),
               psum=mesh.psum(x[3] for x in ins),
               pmax=mesh.pmax(x[3] for x in ins),
               n=mesh.n, shard_ids=np.array(mesh.shard_ids),
               files=np.array(multihost.partition_files(files)))
    for name, c in (("rows", 1), ("bytes", 2)):
        for gid, got in zip(mesh.shard_ids, mesh.all_to_all(
                [x[c] for x in ins])):
            out[f"{name}{gid}"] = got.numpy()
    sc = sharded.ShardedCounter(mesh=mesh, k=21, key_bits=20,
                                local_capacity=1 << 14,
                                local_buf_capacity=1 << 10)
    specs = sc.from_host(*_spread_keys())
    out["node_cap"] = sharded_contiger.node_cap_for(mesh, specs)
    refused = []
    for name, call in (
            ("gather_spectrum", lambda: sc.gather_spectrum(specs)),
            ("assemble_unitigs_sharded",
             lambda: sharded_contiger.assemble_unitigs_sharded(
                 sc, specs, [], cfg.ContigerParams(k=21))),
            ("make_counter", lambda: driver.make_counter(
                cfg.CounterSizing(k=21, qb=12, hb=20, num_true_kmers=0,
                                  num_false_kmers=0, n_true_kmers=1,
                                  num_deNoise=0, ndistinct_for_deNoise=1,
                                  end_deNoise=False, fr=0.0),
                2, cfg.BatchConfig(), device=DEV))):
        try:
            call()
        except ValueError as e:
            if "fault 10" in str(e):
                refused.append(name)
    out["refused"] = np.array(refused)
    return out


def _task_overflow(mesh, rank, how):
    """A store overflow on process 0's shards only.  ``agreed``: a merge
    overflows shard 0's store, and the fullest store of the mesh decides,
    so both processes raise at once.  ``local``: loading shard 0 overflows
    it on process 0 alone, which raises on its own; process 1 waits in its
    next collective until the group ends it."""
    kb, C = 20, 256
    sc = sharded.ShardedCounter(mesh=mesh, k=21, key_bits=kb,
                                local_capacity=C, local_buf_capacity=2 * C)
    low = np.arange(1, 1 + 2 * C, dtype=np.uint64)  # all in shard 0's range
    if how == "local":
        specs = sc.from_host(low, np.full(len(low), 2, np.int64))
    else:
        specs = sc.from_host(low[:C // 2], np.full(C // 2, 2, np.int64))
        if rank == 0:
            specs[0] = sp.insert(specs[0], torch.from_numpy(
                low[C // 2:].astype(np.int64)))
        specs = sc.merge(specs)
    sc.stats(specs)
    return {}


TASKS = dict(count_scan=_task_count_scan, count_files=_task_count_files,
             contig=_task_contig, exchange=_task_exchange,
             overflow=_task_overflow)


def _worker(rank, store, out, task, kw):
    torch.set_num_threads(2)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=WORLD,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
    try:
        mesh = multihost.make_global_mesh(DEV, local=LOCAL)
        res = TASKS[task](mesh, rank, **kw)
    except Exception as e:
        with open(os.path.join(out, f"err_{rank}.txt"), "w") as f:
            f.write(f"{type(e).__name__}: {e}")
        raise
    np.savez(os.path.join(out, f"res_{rank}.npz"), **res)
    dist.destroy_process_group()


def _spawn(tmp_path, task, **kw):
    """Run a task in WORLD processes -> (exit codes, seconds); a worker
    still alive after JOIN_TIMEOUT is killed."""
    t0 = time.time()
    ctx = mp.spawn(_worker, args=(str(tmp_path / "store"), str(tmp_path),
                                  task, kw),
                   nprocs=WORLD, join=False)
    for p in ctx.processes:
        p.join(max(t0 + JOIN_TIMEOUT - time.time(), 0))
    hung = [p for p in ctx.processes if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    assert not hung, f"{len(hung)} worker(s) hung past {JOIN_TIMEOUT} s"
    return [p.exitcode for p in ctx.processes], time.time() - t0


def _errors(tmp_path):
    return {r: (tmp_path / f"err_{r}.txt").read_text()
            for r in range(WORLD) if (tmp_path / f"err_{r}.txt").exists()}


def _run(tmp_path, task, **kw):
    """A task that must succeed -> each process's results."""
    codes, _ = _spawn(tmp_path, task, **kw)
    assert codes == [0] * WORLD, (codes, _errors(tmp_path))
    return [dict(np.load(tmp_path / f"res_{r}.npz")) for r in range(WORLD)]


# ---------------------------------------------------------------------------
# Comparisons


PLANES = ("hi", "lo", "buf_hi", "buf_lo")
SCALARS = ("n_main", "n_buf", "ndistinct", "nelts")


def _worker_states(res) -> list[dict]:
    """The shards' states from every process's dump, in global order."""
    merged = {k: v for r in res for k, v in r.items()}
    return [{f: merged[f"s{g}_{f}"] for f in PLANES + SCALARS}
            for g in range(N)]


def _jax_states(jspec) -> list[dict]:
    planes = {f: np.asarray(getattr(jspec, f)).reshape(N, -1)
              for f in PLANES}
    scal = {f: np.asarray(getattr(jspec, f)).reshape(-1) for f in SCALARS}
    return [{**{f: planes[f][g] for f in PLANES},
             **{f: scal[f][g] for f in SCALARS}} for g in range(N)]


def _assert_states(got: list[dict], ref: list[dict], what: str):
    assert len(got) == len(ref) == N
    for g, (a, b) in enumerate(zip(got, ref)):
        for f in PLANES + SCALARS:
            np.testing.assert_array_equal(a[f], b[f],
                                          err_msg=f"{what}: shard {g} {f}")


def _jax_stack(jsc, codes, lengths):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    row = NamedSharding(jsc.mesh, P(None, "shard"))
    return (jax.device_put(jnp.asarray(codes), row),
            jax.device_put(jnp.asarray(lengths), row))


# ---------------------------------------------------------------------------
# The tests


def test_two_process_counting_matches_oracle(tmp_path):
    """tests/test_multiprocess.py's run (default_rng(907), 256 reads of 90
    bp, k = 21, key_bits 22, 2^14 slots a shard, one scan of S = 2 and a
    merge) at 2 processes x 2 shards: the union of both dumps is the
    oracle's count, both processes report the oracle's stats, and every
    shard equals the JAX counter's on the 4-device virtual mesh fed the
    same global stack."""
    from sh_assembly_tpu.parallel import sharded as jsharded

    from oracle import oracle_count, random_reads

    k, kb = 21, 22
    reads = random_reads(np.random.default_rng(907), 256, 90)
    expect = oracle_count(reads, k, kb)
    res = _run(tmp_path, "count_scan", reads=reads, k=k, key_bits=kb,
               rows_per_shard=32, L=96)
    got = dict(zip(np.concatenate([r["keys"] for r in res]).tolist(),
                   np.concatenate([r["counts"] for r in res]).tolist()))
    assert got == expect
    for r in res:
        assert int(r["dropped"]) == 0
        assert (int(r["nd"]), int(r["ne"])) == (len(expect),
                                                sum(expect.values()))

    jsc = jsharded.ShardedCounter(mesh=jsharded.make_mesh(N), k=k,
                                  key_bits=kb, local_capacity=1 << 14,
                                  local_buf_capacity=1 << 14)
    codes = np.concatenate([r["codes"] for r in res], axis=1)
    lengths = np.concatenate([r["lengths"] for r in res], axis=1)
    jspec, _ = jsc.append_scan_fn(2)(jsc.init(),
                                     *_jax_stack(jsc, codes, lengths))
    jspec = jsc.merge_fn()(jspec)
    _assert_states(_worker_states(res), _jax_states(jspec), "JAX")


def _write_fastq(path, reads):
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")


def _jax_count(jsc, sc, batches, sizing, rows, L, S):
    """The JAX counter fed ``batches`` at ``driver.count_stream``'s
    cadence -> (state, rounds left after each mid-stream merge)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    jscan, jmsw = jsc.append_scan_fn(S), jsc.merge_sweep_fn()
    jspec = jsc.init()
    jrounds = jax.device_put(np.full(N, sizing.num_deNoise, np.int32),
                             NamedSharding(jsc.mesh, P("shard")))
    threshold = jnp.asarray(sizing.ndistinct_for_deNoise, jnp.int64)
    per_scan = S * sc.routed_per_step(rows // N, L)
    fill, left = 0, []
    for i in range(0, len(batches), S):
        codes = np.full((S, rows, L), 5, np.uint8)
        lengths = np.zeros((S, rows), np.int32)
        for s, b in enumerate(batches[i:i + S]):
            codes[s], lengths[s] = b.codes, b.lengths
        if fill + per_scan > sc.local_buf_capacity:
            jspec, jrounds = jmsw(jspec, jrounds, threshold)
            left.append(int(np.asarray(jrounds)[0]))
            fill = 0
        jspec, _ = jscan(jspec, *_jax_stack(jsc, codes, lengths))
        fill += per_scan
    jspec, jrounds = jmsw(jspec, jrounds, threshold)
    if sizing.end_deNoise:
        jspec = jsc.merge_fn(drop_singletons=True)(jspec)
    return jspec, left


def test_uneven_files_with_sweeps_match_jax(tmp_path):
    """Three read files over two processes: process 0 streams files 0 and
    2, process 1 file 1 and then empty batches (``coordinated_stream``),
    through ``driver.count_stream`` with deNoise sweeps firing mid-stream
    and at the end.  Every shard equals the in-process mesh's and the JAX
    virtual mesh's, fed the same global steps (process 0's rows, then
    process 1's)."""
    from sh_assembly_tpu.parallel import sharded as jsharded

    from oracle import random_genome, reads_from_genome

    rng = np.random.default_rng(5)
    genome = random_genome(rng, 1500)
    files = []
    for i, n_reads in enumerate((300, 120, 200)):
        files.append(str(tmp_path / f"reads{i}.fastq"))
        _write_fastq(files[-1], reads_from_genome(rng, genome, n_reads, 80,
                                                  error_rate=0.02))
    k, qb, rows, L, S = 21, 12, 16, 96, 2
    sizing = cfg.CounterSizing(
        k=k, qb=qb, hb=qb + 8, num_true_kmers=0, num_false_kmers=0,
        n_true_kmers=1, num_deNoise=2, ndistinct_for_deNoise=1500,
        end_deNoise=True, fr=0.0)
    kw = dict(capacity=1 << 13, buf_capacity=1 << 13)
    native.available()  # built here, not by both workers at once
    res = _run(tmp_path, "count_files", files=files, sizing=sizing,
               rows=rows, L=L, S=S, **kw)
    assert [r["files"].tolist() for r in res] == [files[0::2], files[1:2]]
    assert res[0]["batches"] == res[1]["batches"]
    got = _worker_states(res)

    # the global steps: each process's batches, the shorter stream padded
    # with empty batches, process 0's rows first.  One reader thread: with
    # more, the reader streams the files on parallel threads and their
    # reads interleave in an order that depends on timing, and the
    # mid-stream sweeps make the state depend on that order
    local = [list(native.batches_from_files(r["files"].tolist(), k, "auto",
                                            rows, L, n_threads=1))
             for r in res]
    assert len(local[0]) > len(local[1]) > 0
    empty = fastq.Batch(np.full((rows, L), 5, np.uint8),
                        np.zeros(rows, np.int32), 0)
    steps = [fastq.Batch(
        np.concatenate([p[t].codes if t < len(p) else empty.codes
                        for p in local]),
        np.concatenate([p[t].lengths if t < len(p) else empty.lengths
                        for p in local]), 2 * rows)
        for t in range(len(local[0]))]
    sc = sharded.ShardedCounter(mesh=sharded.make_mesh(N, DEV), k=k,
                                key_bits=qb + 8,
                                local_capacity=kw["capacity"],
                                local_buf_capacity=kw["buf_capacity"])
    specs, stats = driver.count_stream(sc, steps, sizing, 2 * rows, L, S)
    assert {f: stats[f] for f in ("sweeps", "merges", "batches")} == \
        {f: int(res[0][f]) for f in ("sweeps", "merges", "batches")}
    _assert_states(got, [sp.to_jax_planes(s) for s in specs], "InProcess")

    jsc = jsharded.ShardedCounter(
        mesh=jsharded.make_mesh(N), k=k, key_bits=qb + 8,
        local_capacity=kw["capacity"],
        local_buf_capacity=kw["buf_capacity"])
    jspec, left = _jax_count(jsc, sc, steps, sizing, 2 * rows, L, S)
    # both sweeps fire mid-stream, and merges follow them
    assert left[:2] == [1, 0] and len(left) >= 3, left
    _assert_states(got, _jax_states(jspec), "JAX")


ARRAYS = ("seq_codes", "offsets", "med", "after_ptr", "after_val",
          "before_ptr", "before_val", "mean")


def test_contiger_steps_match_jax(tmp_path):
    """``collect``, ``phantom`` and ``probe`` at 2 processes x 2 shards
    (``sharded_contiger.shard_parts``): every store and probe part equals
    the in-process mesh's, and ``finish_parts`` on them in this process
    gives the JAX ``assemble_unitigs_sharded``'s arrays on the 4-device
    virtual mesh (the node capacity passed to both, since the port sizes
    for the busiest shard)."""
    from sh_assembly_tpu import config as jcfg
    from sh_assembly_tpu.io import fastq as jfastq
    from sh_assembly_tpu.parallel import sharded as jsharded
    from sh_assembly_tpu.parallel import sharded_contiger as jsc_mod

    from oracle import random_genome, reads_from_genome

    k, kb, B, L, cap, Cl = 21, 20, 32, 80, 8192, 4096
    rng = np.random.default_rng(2038074761)
    reads = reads_from_genome(rng, random_genome(rng, 2500), 700, 72,
                              error_rate=0.015)
    batcher = fastq.Batcher(k, B, L)
    batches = []
    for r in reads:
        batches.extend(batcher.add_read(r))
    batches.extend(batcher.flush())
    batches = [fastq.Batch(
        np.pad(b.codes, ((0, B - len(b.codes)), (0, 0)), constant_values=5),
        np.pad(b.lengths, (0, B - len(b.lengths))), B,
        np.pad(b.seed_col, (0, B - len(b.seed_col)), constant_values=-1))
        for b in batches]

    # the spectrum: the in-process mesh's count of the reads
    sc = sharded.ShardedCounter(mesh=sharded.make_mesh(N, DEV), k=k,
                                key_bits=kb, local_capacity=cap,
                                local_buf_capacity=cap)
    specs = sc.init()
    for b in batches:
        specs = sc.merge(sc.step(specs, *sc.shard_batch(b.codes, b.lengths)))
    keys, counts = sc.gather_spectrum(specs)
    params = cfg.ContigerParams(k=k, kmer_abundance_min=2)

    res = _run(tmp_path, "contig", keys=keys, counts=counts, key_bits=kb,
               capacity=cap, batches=batches, params=params,
               node_cap_local=Cl)
    assert all(bool(r["saw"]) for r in res)
    merged = {key: v for r in res for key, v in r.items()}
    fields = list(sharded_contiger.ShardPart.__dataclass_fields__)
    parts = [sharded_contiger.ShardPart(
        *(torch.from_numpy(merged[f"s{g}_{f}"]) for f in fields))
        for g in range(N)]

    ref, saw = sharded_contiger.shard_parts(
        sc, sc.from_host(keys, counts), batches, params, node_cap_local=Cl)
    assert saw
    for g, (a, b) in enumerate(zip(parts, ref)):
        for f in fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), (g, f)
    assert int(sum(p.valid.sum() for p in parts)) > 1000

    got = sharded_contiger.finish_parts(parts, True, params)
    jsc = jsharded.ShardedCounter(mesh=jsharded.make_mesh(N), k=k,
                                  key_bits=kb, local_capacity=cap,
                                  local_buf_capacity=cap)
    want = jsc_mod.assemble_unitigs_sharded(
        jsc, jsc.from_host(keys, counts),
        [jfastq.Batch(b.codes, b.lengths, b.n_rows, b.seed_col)
         for b in batches],
        jcfg.ContigerParams(k=k, kmer_abundance_min=2), node_cap_local=Cl)
    assert got.n == want.n > 1 and got.n_palindromes == want.n_palindromes
    for f in ARRAYS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


@pytest.mark.parametrize("how", ["agreed", "local"])
def test_overflow_on_one_process_ends_both(tmp_path, how):
    """A store overflow forced on process 0's shards: both processes exit
    non-zero, within the group's timeout.  An overflow the mesh agrees on
    (a merge: the fullest store decides) raises on both at once; one that
    only process 0 sees (a shard loaded past its capacity) ends process 1
    in its next collective."""
    codes, seconds = _spawn(tmp_path, "overflow", how=how)
    errors = _errors(tmp_path)
    assert all(c != 0 for c in codes), (codes, errors)
    assert seconds < GROUP_TIMEOUT + 30, seconds
    if how == "agreed":
        assert all("spectrum overflow" in errors[r] for r in range(WORLD)), \
            errors
    else:
        assert "local capacity" in errors[0], errors


def test_distributed_calls_match_in_process(tmp_path):
    """Every call of the back end with two shards a process equals the
    in-process mesh's on the same inputs: parts of lengths that differ,
    int64 and uint8 rows, the sum and the maximum.  The global mesh spans
    both processes with process-major shard ids, ``partition_files``
    takes the group's rank and size, and the single-process entry points
    (``gather_spectrum``, the Contiger's host tail, ``make_counter``)
    refuse to run; the node capacity is sized from the whole mesh."""
    files = [f"reads{i}.fq" for i in range(5)]
    res = _run(tmp_path, "exchange", files=files)
    ref = collectives.InProcess(N, DEV)
    ins = [_exchange_inputs(g, N) for g in range(N)]
    want_rows = ref.all_to_all([x[1] for x in ins])
    want_bytes = ref.all_to_all([x[2] for x in ins])
    for rank, r in enumerate(res):
        assert int(r["n"]) == N
        assert r["shard_ids"].tolist() == [rank * LOCAL + i
                                           for i in range(LOCAL)]
        assert r["files"].tolist() == files[rank::WORLD]
        np.testing.assert_array_equal(
            r["gather"], ref.all_gather([x[0] for x in ins]).numpy())
        assert int(r["psum"]) == ref.psum(x[3] for x in ins)
        assert int(r["pmax"]) == ref.pmax(x[3] for x in ins)
        for g in r["shard_ids"].tolist():
            np.testing.assert_array_equal(r[f"rows{g}"], want_rows[g].numpy())
            np.testing.assert_array_equal(r[f"bytes{g}"],
                                          want_bytes[g].numpy())
            assert r[f"bytes{g}"].dtype == np.uint8
        assert int(r["node_cap"]) == sharded_contiger.node_cap_for(
            ref, sharded.ShardedCounter(
                mesh=ref, k=21, key_bits=20, local_capacity=1 << 14,
                local_buf_capacity=1 << 10).from_host(*_spread_keys()))
        assert r["refused"].tolist() == ["gather_spectrum",
                                         "assemble_unitigs_sharded",
                                         "make_counter"]
