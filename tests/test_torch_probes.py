"""The plain versions of kernels K7 (the node join, ``kmerpack.join2_plain``)
and K8 (the node probes, ``probe_cuda.node_probes_plain``) against the JAX
package's ``join2`` and probe functions, bitwise, on the CPU, and the
dispatch that sends CPU tensors to them.

The node join's tables hold duplicate pairs (a pair repeated, sentinel pad
rows, repeated real pairs: the largest index answers), come in random
order, and meet queries that are absent, repeated or the sentinel
(``chip_smoke.k7_tables``, which smoke phase 16 and tests/test_torch_cuda.py
hold K7 against ``join2_plain`` with).  The node probes run in both modes at
k on both sides of 32 with padding rows (``chip_smoke.k8_nodes``) against
``_node_hashes``, ``revcomp_packed``, ``_succ_probes`` and
``_sibling_probes``.  Tolerance: exact (integers)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from sh_assembly_tpu.models import contiger as jcontiger
from sh_assembly_tpu.ops import kmerpack as jkp
from sh_assembly_tpu_torch import config as cfg
from sh_assembly_tpu_torch.io import fastq
from sh_assembly_tpu_torch.models import contiger, counter
from sh_assembly_tpu_torch.ops import bits, kmerpack as kp, node_join_cuda, \
    probe_cuda, spectrum as sp
from sh_assembly_tpu_torch.parallel import sharded, sharded_contiger

from oracle import random_genome, reads_from_genome

DEV = "cpu"  # the port's functions default to the GPU

U64 = np.uint64
SENT = U64(0xFFFFFFFFFFFFFFFF)

K7_CASES = {c[0]: c[1:] for c in chip_smoke.k7_tables()}


def _t(a) -> torch.Tensor:
    return bits.from_u64_np(np.asarray(a, U64), DEV)


def _u(t: torch.Tensor) -> np.ndarray:
    return bits.to_u64_np(t)


@pytest.mark.parametrize("name", sorted(K7_CASES))
def test_join2_plain_matches_jax(name):
    thi, tlo, qhi, qlo = K7_CASES[name]
    got = kp.join2_plain(*map(_t, (thi, tlo, qhi, qlo)))
    assert got.dtype == torch.int32 and got.shape == (len(qhi),)
    if len(qhi):
        ref = np.asarray(jkp.join2(*map(jnp.asarray, (thi, tlo, qhi, qlo))))
        np.testing.assert_array_equal(got.numpy(), ref)
    # every answer holds the query's pair, and no larger row does
    g = got.numpy()
    hit = g >= 0
    np.testing.assert_array_equal(thi[g[hit]], qhi[hit])
    np.testing.assert_array_equal(tlo[g[hit]], qlo[hit])
    last = {}
    for r, pair in enumerate(zip(thi.tolist(), tlo.tolist())):
        last[pair] = r
    want = [last.get(p, -1) for p in zip(qhi.tolist(), qlo.tolist())]
    np.testing.assert_array_equal(g, want)


def test_join2_plain_answers_the_largest_duplicate():
    a, b, c = (U64(v) << U64(40) for v in (3, 5, 7))
    thi = np.array([a, b, a, SENT, SENT, b, SENT], U64)
    tlo = np.array([0, 0, 0, SENT, SENT, 0, SENT], U64)
    qhi = np.array([a, b, SENT, c, a], U64)
    qlo = np.array([0, 0, SENT, 0, 0], U64)
    got = kp.join2_plain(*map(_t, (thi, tlo, qhi, qlo)))
    np.testing.assert_array_equal(got.numpy(), [2, 5, 6, -1, 2])
    ref = jkp.join2(*map(jnp.asarray, (thi, tlo, qhi, qlo)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_join2_refuses_what_the_jax_package_refuses():
    kp.join2_check(1 << 24, 1 << 28)  # closure round 1 at phase 7's shape
    for n, q in ((1 << 30, 1 << 31), (1 << 31, 0)):
        with pytest.raises(ValueError, match="join2 packing overflow"):
            kp.join2_check(n, q)
    z = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError):  # K7's wrapper takes no CPU tensor
        node_join_cuda.node_join(z, z, z, z)
    assert [node_join_cuda.slots_for(n) for n in (0, 1, 32, 33, 1 << 24)] \
        == [64, 64, 64, 128, 1 << 25]


def _jax_probes(hi, lo, k, key_bits, mode):
    """The JAX package's probe chain -> the outputs of node_probes as
    numpy (keys, hi, lo, flip or None)."""
    jh, jl = jnp.asarray(hi), jnp.asarray(lo)
    mask = U64((1 << key_bits) - 1)
    fh0, rh0 = jcontiger._node_hashes(jh, jl, k)
    rhi, rlo = jkp.revcomp_packed(jh, jl, k)
    keys, shi, slo, sflip = jcontiger._succ_probes(jh, jl, rhi, rlo, fh0,
                                                   rh0, k, mask)
    if mode == "graph":
        keys = [jnp.minimum(fh0, rh0) & mask] + keys
        return (np.stack(keys), np.stack(shi), np.stack(slo),
                np.stack(sflip))
    skeys, whi, wlo = jcontiger._sibling_probes(jh, jl, rhi, rlo, fh0, rh0,
                                                k, mask)
    return (np.stack(keys + skeys), np.stack(shi + whi), np.stack(slo + wlo),
            None)


@pytest.mark.parametrize("mode", probe_cuda.MODES)
@pytest.mark.parametrize("k", [21, 32, 33, 47, 63])
def test_node_probes_plain_matches_jax(k, mode):
    kb = {21: 22, 32: 34, 33: 63, 47: 34, 63: 40}[k]
    hi, lo = chip_smoke.k8_nodes(k, 700, 90 + k)
    assert (hi == SENT).sum() > 40  # padding rows among the nodes
    got = probe_cuda.node_probes_plain(_t(hi), _t(lo), k, kb, mode)
    ref = _jax_probes(hi, lo, k, kb, mode)
    rows = probe_cuda.ROWS[mode]
    assert got[0].shape == (rows[0], 700) and got[1].shape == (rows[1], 700)
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_array_equal(_u(a), b)
    if mode == "graph":
        assert got[3].dtype == torch.int32
        np.testing.assert_array_equal(got[3].numpy(), ref[3])
    else:
        assert got[3] is None and ref[3] is None


def test_node_probes_refuse_what_the_kernel_does_not_take():
    z = torch.zeros(4, dtype=torch.int64)
    for args in ((z, z, 0, 22, "graph"), (z, z, 64, 22, "graph"),
                 (z, z, 47, 0, "closure"), (z, z, 47, 64, "graph"),
                 (z, z, 47, 22, "siblings"), (z, z[:3], 47, 22, "graph"),
                 (z.int(), z.int(), 47, 22, "graph")):
        with pytest.raises(ValueError):
            probe_cuda.node_probes(*args)
    with pytest.raises(ValueError):  # K8's wrapper takes no CPU tensor
        probe_cuda.node_probes_cuda(z, z, 47, 22, "graph")


@pytest.fixture
def spied(monkeypatch):
    """Counts of the calls of join2, node_probes (by mode), their plain
    versions and a node table's build, append and probe, and the kernels'
    launches before the test."""
    calls = {"join2": 0, "join2_plain": 0, "node_probes_plain": 0,
             "graph": 0, "closure": 0, "build": 0, "append": 0, "probe": 0}

    def spy(mod, name, key=None):
        fn = getattr(mod, name)

        def call(*a, **kw):
            calls[key(*a) if key else name] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, call)

    spy(kp, "join2")
    spy(kp, "join2_plain")
    spy(probe_cuda, "node_probes", lambda *a: a[4])
    spy(probe_cuda, "node_probes_plain")
    for kind in ("build", "append", "probe"):
        spy(node_join_cuda.NodeTable, kind)
    return calls, (node_join_cuda.LAUNCHES, probe_cuda.LAUNCHES)


def test_cpu_tensors_take_the_plain_versions(spied):
    calls, launches = spied
    hi, lo = chip_smoke.k8_nodes(31, 64, 5)
    h, l = _t(hi), _t(lo)
    assert torch.equal(kp.join2(h, l, h, l), kp.join2_plain(h, l, h, l))
    for mode in probe_cuda.MODES:
        for a, b in zip(probe_cuda.node_probes(h, l, 31, 30, mode),
                        probe_cuda.node_probes_plain(h, l, 31, 30, mode)):
            assert (a is None and b is None) or torch.equal(a, b)
    assert calls == {"join2": 1, "join2_plain": 2, "node_probes_plain": 4,
                     "graph": 1, "closure": 1, "build": 0, "append": 0,
                     "probe": 0}
    assert (node_join_cuda.LAUNCHES, probe_cuda.LAUNCHES) == launches


def test_probe_programs_reach_node_probes_and_join2(spied):
    """phantom_candidates probes in closure mode and build_oriented_graph in
    graph mode, each through one node_probes call and one node join: a
    one-shot join2 call without a table, one probe of the table they are
    given (built once for both, as the Contiger shares it)."""
    calls, launches = spied
    rng = np.random.default_rng(3)
    genome = rng.integers(0, 4, 3000).astype(np.uint8)
    starts = rng.integers(0, 3000 - 100, 200)
    codes = genome[starts[:, None] + np.arange(100)]
    hp, lp = kp.pack_windows(torch.from_numpy(codes), 31)
    hp, lp = hp.reshape(-1)[:2000], lp.reshape(-1)[:2000]
    spec = counter.count_batch(
        sp.make(1 << 14, 1 << 14, DEV), torch.from_numpy(codes),
        torch.full((200,), 100, dtype=torch.int32), 31, 22)
    spec = sp.merge(spec, 22)
    pad = torch.full((2048,), -1, dtype=torch.int64)
    h, l = pad.clone(), pad.clone()
    h[:2000], l[:2000] = hp, lp
    one_shot = contiger.phantom_candidates(spec, h, l, h, l, 31, 22, 2)
    assert (calls["closure"], calls["graph"], calls["join2"]) == (1, 0, 1)
    table = node_join_cuda.NodeTable().build(h, l, 2000)
    got = contiger.phantom_candidates(spec, h, l, h, l, 31, 22, 2, table)
    contiger.build_oriented_graph(spec, h, l, 31, 22, 2, table=table)
    assert (calls["closure"], calls["graph"], calls["join2"]) == (2, 1, 1)
    assert (calls["build"], calls["append"], calls["probe"]) == (1, 0, 2)
    for a, b in zip(got, one_shot):
        assert a == b if isinstance(a, int) else torch.equal(a, b)
    # the table's plain route is join2_plain, as the one-shot's is
    assert calls["join2_plain"] == 3 and calls["node_probes_plain"] == 3
    assert (node_join_cuda.LAUNCHES, probe_cuda.LAUNCHES) == launches


def test_mesh_contiger_reaches_node_probes_and_join2(spied):
    """The mesh Contiger's closure rounds and graph probe every shard's
    nodes through node_probes and join them through join2."""
    calls, launches = spied
    k, qb, n = 21, 12, 2
    rng = np.random.default_rng(8)
    reads = reads_from_genome(rng, random_genome(rng, 1500), 400, 72,
                              error_rate=0.01)
    sc = sharded.ShardedCounter(mesh=sharded.make_mesh(n, DEV), k=k,
                                key_bits=qb + 8, local_capacity=4096,
                                local_buf_capacity=4096)
    specs = sc.init()
    for x in _batches(k, reads):
        specs = sc.merge(sc.step(specs, *sc.shard_batch(x.codes, x.lengths)))
    au = sharded_contiger.assemble_unitigs_sharded(
        sc, specs, _batches(k, reads),
        cfg.ContigerParams(k=k, kmer_abundance_min=2))
    assert au.n > 1
    assert calls["closure"] >= n and calls["graph"] == n
    # the mesh joins through one-shot join2 round trips, no kept table
    assert calls["join2"] >= calls["closure"] + calls["graph"]
    assert calls["build"] == calls["probe"] == 0
    assert calls["node_probes_plain"] == calls["closure"] + calls["graph"]
    assert (node_join_cuda.LAUNCHES, probe_cuda.LAUNCHES) == launches


def _batches(k, reads, rows=32, L=80):
    """Equal-row batches of the reads (the mesh wants a fixed geometry)."""
    bt = fastq.Batcher(k, rows, L)
    out = [x for r in reads for x in bt.add_read(r)] + list(bt.flush())
    padded = []
    for x in out:
        c, ln = x.codes, x.lengths
        if c.shape[0] < rows:
            c = np.pad(c, ((0, rows - c.shape[0]), (0, 0)),
                       constant_values=5)
            ln = np.pad(ln, (0, rows - len(ln)))
        padded.append(fastq.Batch(codes=c, lengths=ln, n_rows=rows))
    return padded
