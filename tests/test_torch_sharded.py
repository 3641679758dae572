"""The port's sharded counter (``parallel/sharded.py`` over the in-process
back end, on the CPU) against the JAX package's on the 8-device virtual
CPU mesh, bitwise: every shard's whole state (store and buffer planes,
n_main, n_buf, ndistinct, nelts) after the all-gather step, the routed
scan with its ``dropped`` count, merges and sweeps with the summed
trigger, and ``stats``, ``from_host`` and ``make_mesh``.  Tolerance:
exact."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from sh_assembly_tpu import config as jcfg
from sh_assembly_tpu.io import fastq as jfastq
from sh_assembly_tpu.parallel import driver as jdriver
from sh_assembly_tpu.parallel import multihost as jmultihost
from sh_assembly_tpu.parallel import sharded as jsharded
from sh_assembly_tpu_torch import config as cfg
from sh_assembly_tpu_torch.ops import spectrum as sp
from sh_assembly_tpu_torch.parallel import collectives, driver, multihost, \
    sharded

from oracle import oracle_count, random_genome, random_reads, \
    reads_from_genome

DEV = "cpu"  # the port's functions default to the GPU
K, QB = 21, 12
KEY_BITS = QB + 8
B, L = 16, 96


def _batches(reads):
    b = jfastq.Batcher(K, B, L)
    out = []
    for r in reads:
        out.extend(b.add_read(r))
    out.extend(b.flush())
    return out


@pytest.fixture(scope="module")
def reads():
    rng = np.random.default_rng(2038074761)
    return random_reads(rng, 64, 90)


@pytest.fixture(scope="module")
def genome_reads():
    rng = np.random.default_rng(7)
    # ~25x coverage with 2 % errors: a stream of singletons to sweep
    return reads_from_genome(rng, random_genome(rng, 1500), 500, 80,
                             error_rate=0.02)


def _pair(n, cap=8192, buf=8192):
    jsc = jsharded.ShardedCounter(
        mesh=jsharded.make_mesh(n), k=K, key_bits=KEY_BITS,
        local_capacity=cap, local_buf_capacity=buf)
    sc = sharded.ShardedCounter(
        mesh=sharded.make_mesh(n, DEV), k=K, key_bits=KEY_BITS,
        local_capacity=cap, local_buf_capacity=buf)
    return jsc, sc


def _assert_same(specs, jspec, n):
    """Every shard's state in the JAX layout, bitwise."""
    planes = {f: np.asarray(getattr(jspec, f)).reshape(n, -1)
              for f in ("hi", "lo", "buf_hi", "buf_lo")}
    scal = {f: np.asarray(getattr(jspec, f)).reshape(-1)
            for f in ("n_main", "n_buf", "ndistinct", "nelts")}
    assert len(specs) == n
    for s, spec in enumerate(specs):
        got = sp.to_jax_planes(spec)
        for f, v in scal.items():
            assert got[f] == int(v[s]), (s, f)
        for f, v in planes.items():
            np.testing.assert_array_equal(got[f], v[s], err_msg=f"{s} {f}")


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_step_and_merge_match_jax(reads, n):
    """All-gather routing, a merge after every step, the gathered store,
    stats; at n = 8 the oracle too."""
    jsc, sc = _pair(n)
    jstep, jmerge = jsc.step_fn(), jsc.merge_fn()
    jspec, specs = jsc.init(), sc.init()
    for b in _batches(reads):
        jspec = jmerge(jstep(jspec, *jsc.shard_batch(b.codes, b.lengths)))
        specs = sc.merge(sc.step(specs, *sc.shard_batch(b.codes, b.lengths)))
    _assert_same(specs, jspec, n)
    keys, counts = sc.gather_spectrum(specs)
    jkeys, jcounts = jsc.gather_spectrum(jspec)
    np.testing.assert_array_equal(keys, jkeys)
    np.testing.assert_array_equal(counts, jcounts)
    assert sc.stats(specs) == jsc.stats_fn()(jspec)
    if n == 8:
        assert dict(zip(keys.tolist(), counts.tolist())) == \
            oracle_count(reads, K, KEY_BITS)


def test_step_merges_before_overflow(reads):
    """A buffer that holds two gathered blocks: the step merges before the
    third, mid-stream, as the JAX step does; then the sweep case of the
    JAX package's own tests (merge with drop_singletons at the end)."""
    n = 4
    jsc, sc = _pair(n, buf=B * (L - K + 1) * 2)
    jstep = jsc.step_fn()
    jspec, specs = jsc.init(), sc.init()
    for b in _batches(reads):
        jspec = jstep(jspec, *jsc.shard_batch(b.codes, b.lengths))
        specs = sc.step(specs, *sc.shard_batch(b.codes, b.lengths))
        _assert_same(specs, jspec, n)
    jspec = jsc.merge_fn(drop_singletons=True)(jspec)
    specs = sc.merge(specs, drop_singletons=True)
    _assert_same(specs, jspec, n)
    keys, counts = sc.gather_spectrum(specs)
    assert dict(zip(keys.tolist(), counts.tolist())) == {
        k: v for k, v in oracle_count(reads, K, KEY_BITS).items() if v >= 2}


def _stacks(batches, S):
    for i in range(0, len(batches), S):
        codes = np.full((S, B, L), 5, np.uint8)
        lengths = np.zeros((S, B), np.int32)
        for s, b in enumerate(batches[i:i + S]):
            codes[s], lengths[s] = b.codes, b.lengths
        yield codes, lengths


def _jax_stack(jsc, codes, lengths):
    row = NamedSharding(jsc.mesh, P(None, "shard"))
    return (jax.device_put(jnp.asarray(codes), row),
            jax.device_put(jnp.asarray(lengths), row))


@pytest.mark.parametrize("n,slack", [(1, 2.0), (2, 2.0), (4, 2.0), (8, 2.0),
                                     (4, 0.3)],
                         ids=["n1", "n2", "n4", "n8", "n4_dropping"])
def test_append_scan_matches_jax(reads, n, slack):
    """The routed scan: the buffers after every scan (quota rows and their
    padding in place), ``dropped`` per shard, the merged store."""
    S = 2
    jsc, sc = _pair(n, buf=1 << 14)
    jscan = jsc.append_scan_fn(S, quota_slack=slack)
    jspec, specs = jsc.init(), sc.init()
    jdrop = np.zeros(n, np.int64)
    drop = np.zeros(n, np.int64)
    for codes, lengths in _stacks(_batches(reads), S):
        jspec, jd = jscan(jspec, *_jax_stack(jsc, codes, lengths))
        specs, d = sc.append_scan(specs, *sc.shard_batch(codes, lengths),
                                  quota_slack=slack)
        jdrop += np.asarray(jd)
        drop += d
        _assert_same(specs, jspec, n)
    np.testing.assert_array_equal(drop, jdrop)
    assert (drop.sum() > 0) == (slack < 1)
    jspec = jsc.merge_fn()(jspec)
    specs = sc.merge(specs)
    _assert_same(specs, jspec, n)
    if slack >= 1:
        keys, counts = sc.gather_spectrum(specs)
        assert dict(zip(keys.tolist(), counts.tolist())) == \
            oracle_count(reads, K, KEY_BITS)


@pytest.mark.parametrize("n,buf", [(2, 1 << 13), (8, 1 << 11)])
def test_merge_sweep_cadence_matches_jax(genome_reads, n, buf):
    """Scans and merges at the host's cadence with the summed deNoise
    trigger: sweeps fire mid-stream on the same merges, rounds run out,
    and every state matches after every merge."""
    S = 2
    jsc, sc = _pair(n, cap=1 << 13, buf=buf)  # 3 scans a merge
    jscan, jmsw = jsc.append_scan_fn(S), jsc.merge_sweep_fn()
    jspec, specs = jsc.init(), sc.init()
    rounds, threshold = 2, 1500
    jrounds = jax.device_put(np.full(n, rounds, np.int32),
                             NamedSharding(jsc.mesh, P("shard")))
    per_scan = S * sc.routed_per_step(B // n, L)
    fill, left = 0, []
    for codes, lengths in _stacks(_batches(genome_reads), S):
        if fill + per_scan > sc.local_buf_capacity:
            jspec, jrounds = jmsw(jspec, jrounds,
                                  jnp.asarray(threshold, jnp.int64))
            specs, rounds = sc.merge_sweep(specs, rounds, threshold)
            assert rounds == int(np.asarray(jrounds)[0])
            _assert_same(specs, jspec, n)
            left.append(rounds)
            fill = 0
        jspec, _ = jscan(jspec, *_jax_stack(jsc, codes, lengths))
        specs, _ = sc.append_scan(specs, *sc.shard_batch(codes, lengths))
        fill += per_scan
    # a sweep at each of the first two merges, merges after rounds ran out
    assert left[:2] == [1, 0] and len(left) >= 3, left
    nd, ne = sc.stats(specs)
    assert (nd, ne) == jsc.stats_fn()(jspec)


def test_stats_and_from_host_match_jax():
    """from_host partitions by the owner boundaries; every shard carries
    nelts = total // n, as in the JAX layer, so stats sums to n * (total
    // n)."""
    n = 4
    rng = np.random.default_rng(3)
    keys = np.unique(rng.integers(0, 1 << KEY_BITS, size=3000,
                                  dtype=np.uint64))
    keys = np.concatenate([keys, [np.uint64((1 << KEY_BITS) - 1)]])
    keys = np.unique(keys)
    counts = rng.integers(1, 60, size=len(keys)).astype(np.int64)
    trav = (rng.random(len(keys)) < 0.3).astype(np.uint8)
    jsc, sc = _pair(n)
    specs = sc.from_host(keys, counts, traveled=trav)
    jspec = jsc.from_host(keys, counts, traveled=trav)
    _assert_same(specs, jspec, n)
    total = int(counts.sum())
    assert sc.stats(specs) == jsc.stats_fn()(jspec) == \
        (len(keys), n * (total // n))
    assert [int(s.nelts) for s in specs] == [total // n] * n
    assert {s.n_main for s in specs} != {0}
    with pytest.raises(ValueError, match="local capacity"):
        sharded.ShardedCounter(
            mesh=sharded.make_mesh(n, DEV), k=K, key_bits=KEY_BITS,
            local_capacity=256, local_buf_capacity=256).from_host(keys,
                                                                  counts)


@pytest.mark.parametrize("n", [3, 6, 0])
def test_make_mesh_refuses_other_sizes(n):
    with pytest.raises(ValueError, match="not a power of two"):
        sharded.make_mesh(n, DEV)
    if n:
        with pytest.raises(ValueError, match="not a power of two"):
            jsharded.make_mesh(n)


def test_collectives_in_process():
    import torch

    c = collectives.InProcess(2, DEV)
    assert torch.equal(c.all_gather([torch.arange(2), torch.arange(3)]),
                       torch.tensor([0, 1, 0, 1, 2]))
    rows = [torch.tensor([[1, 2], [3, 4]]), torch.tensor([[5, 6], [7, 8]])]
    got = c.all_to_all(rows)
    assert [g.tolist() for g in got] == [[1, 2, 5, 6], [3, 4, 7, 8]]
    assert c.psum([3, torch.tensor(4)]) == 7


@pytest.mark.parametrize("count", [1, 2, 3])
def test_multihost_matches_jax_in_one_process(count):
    """partition_files is the JAX round robin for any process count; with
    one process the mesh, the stream and the batch placement pass
    through."""
    import torch

    paths = [f"reads{i}.fq" for i in range(7)]
    for index in range(count):
        assert multihost.partition_files(paths, index, count) == \
            jmultihost.partition_files(paths, index, count)
    assert multihost.make_global_mesh(DEV).n == 1
    mesh = sharded.make_mesh(2, DEV)
    assert list(multihost.coordinated_stream(iter("ab"), mesh, None)) == \
        ["a", "b"]
    codes = np.arange(12, dtype=np.uint8).reshape(4, 3)
    c, ln = multihost.shard_host_batch(mesh, codes, np.arange(4))
    assert [x.tolist() for x in c] == [codes[:2].tolist(),
                                       codes[2:].tolist()]
    assert [x.tolist() for x in ln] == [[0, 1], [2, 3]]
    assert all(isinstance(x, torch.Tensor) for x in c + ln)


def test_make_counter_buffer_rule_matches_jax():
    """The local buffer holds a full scan of super_batch routed blocks, and
    the sizing equals the JAX driver's (tests/test_sharded.py:127)."""
    kw = dict(k=31, qb=20, hb=28, num_true_kmers=0, num_false_kmers=0,
              n_true_kmers=1, num_deNoise=0, ndistinct_for_deNoise=1 << 62,
              end_deNoise=False, fr=0.0)
    bc = cfg.BatchConfig()  # the CLI defaults: 8192 reads x 160 bp
    for n_mesh in (1, 2, 4, 8):
        for S in (2, 4, 8):
            sc = driver.make_counter(cfg.CounterSizing(**kw), n_mesh, bc,
                                     super_batch=S, device=DEV)
            jsc = jdriver.make_counter(jcfg.CounterSizing(**kw), n_mesh,
                                       jcfg.BatchConfig(), super_batch=S)
            per_step = sc.routed_per_step(
                bc.reads_per_batch // sc.n_shards, bc.max_read_len)
            assert S * per_step <= sc.local_buf_capacity
            assert (sc.n_shards, sc.local_capacity, sc.local_buf_capacity) \
                == (jsc.n_shards, jsc.local_capacity, jsc.local_buf_capacity)
            assert per_step == jsc.routed_per_step(
                bc.reads_per_batch // n_mesh, bc.max_read_len)
