"""The node table of kernel K7 (``ops/node_join_cuda.NodeTable``) on the
CPU, where it answers with ``join2_plain`` over the rows it holds, against
the JAX package's ``join2`` on the store the JAX Contiger pads, round by
round.

Tables grown as the closure grows its store (``chip_smoke.k7_growth``,
which smoke phase 16 and tests/test_torch_cuda.py hold the kernels
against ``join2_plain`` with): appends inside the padded extent, filling
it exactly (a sentinel query then answers -1), crossing it, a store full
at the first build, appended rows repeating earlier rows and each other.
A small phantom closure (k = 21, a 3 kbp genome with errors, a key space
dense enough for phantoms in four rounds): every probe of the one table
against the JAX closure's padded store of that round; the whole Contiger
with the table shared by the closure and the graph against the JAX
package's ``ArrayUnitigs`` and ``unitigs.fa``.  Tolerance: exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from sh_assembly_tpu import config as jcfg
from sh_assembly_tpu.io import fastq as jfastq
from sh_assembly_tpu.models import contiger as jcontiger
from sh_assembly_tpu.models import counter as jcounter
from sh_assembly_tpu.ops import kmerpack as jkp
from sh_assembly_tpu_torch import config as cfg
from sh_assembly_tpu_torch.io import fastq
from sh_assembly_tpu_torch.models import contiger
from sh_assembly_tpu_torch.ops import bits, kmerpack as kp, \
    node_join_cuda as nj, spectrum as sp
from sh_assembly_tpu_torch.profile import node_join as prof_nj

DEV = "cpu"  # the port's functions default to the GPU

U64 = np.uint64
SENT = U64(0xFFFFFFFFFFFFFFFF)
GROWTH = {c[0]: c[1:] for c in chip_smoke.k7_growth()}
K, KEY_BITS, ROWS, L = 21, 18, 8, 104


def _t(a) -> torch.Tensor:
    return bits.from_u64_np(np.asarray(a, U64), DEV)


def _jax_padded(h, l):
    """The JAX closure's padded store of rows (h, l) (its ``padded``)."""
    n = len(h)
    Np = 1 << max(int(np.ceil(np.log2(max(n, 1024)))), 10)
    hp, lp = np.full(Np, SENT), np.full(Np, SENT)
    hp[:n], lp[:n] = h, l
    return hp, lp


def _jax_join2(th, tl, qh, ql) -> np.ndarray:
    return np.asarray(jkp.join2(*map(jnp.asarray, (th, tl, qh, ql))))


# steps of each growth case: (real rows, padded extent) after the build and
# after each append
EXTENTS = {
    "appends_k47": [(3000, 4096), (3100, 4096), (3600, 4096), (3601, 4096),
                    (3638, 4096)],
    "fills_then_crosses_k47": [(1000, 1024), (1020, 1024), (1024, 1024),
                               (1034, 2048)],
    "crosses_k21": [(4000, 4096), (4200, 8192), (4250, 8192)],
    "fills_k63": [(10, 1024), (15, 1024), (1015, 1024), (1024, 1024)],
    "full_at_build_k31": [(1024, 1024), (1027, 2048), (1727, 2048)],
}


@pytest.mark.parametrize("name", sorted(GROWTH))
def test_table_grows_like_jax_join2(name):
    hi0, lo0, appends, qhi, qlo = GROWTH[name]
    steps = []
    for rows_hi, rows_lo, table, got in chip_smoke.k7_grow(
            DEV, hi0, lo0, appends, qhi, qlo):
        ph, pl = _jax_padded(rows_hi, rows_lo)
        np.testing.assert_array_equal(bits.to_u64_np(table.hi), ph)
        np.testing.assert_array_equal(bits.to_u64_np(table.lo), pl)
        assert table.n_real == len(rows_hi)
        assert got.dtype == torch.int32
        want = _jax_join2(ph, pl, qhi, qlo)
        np.testing.assert_array_equal(got.numpy(), want)
        sent = want[(qhi == SENT) & (qlo == SENT)]
        # the pad's last row answers the sentinel, or none is left
        assert set(sent) == {len(ph) - 1 if len(rows_hi) < len(ph) else -1}
        steps.append((len(rows_hi), len(ph)))
    assert steps == EXTENTS[name]


def test_table_refuses_what_breaks_the_answers():
    h, l = contiger._padded(_t(np.arange(1, 101, dtype=U64) << U64(20)),
                            torch.zeros(100, dtype=torch.int64))
    one = torch.ones(1, dtype=torch.int64)
    table = nj.NodeTable().build(h.clone(), l.clone())
    with pytest.raises(ValueError):  # no promise of a sentinel tail
        table.append(one, one, 100)
    table = nj.NodeTable().build(h.clone(), l.clone(), 100)
    for first, m in ((99, 1), (101, 1), (100, 924)):  # not after the real
        with pytest.raises(ValueError):  # rows, or no pad row left
            table.append(one.repeat(m), one.repeat(m), first)
    with pytest.raises(ValueError):
        table.append(one, one.repeat(2), 100)
    with pytest.raises(ValueError):
        nj.NodeTable().build(h, l, 1025)
    with pytest.raises(ValueError):
        nj.NodeTable().build(h, l[:-1])
    with pytest.raises(ValueError):
        table.probe(one.int(), one.int())
    table.append(one, one, 100)
    assert table.n_real == 101 and int(table.probe(one, one)) == 100
    # a probe program refuses a table of another store
    with pytest.raises(ValueError, match="another store"):
        contiger.build_oriented_graph(None, h, l, K, KEY_BITS, 2,
                                      table=table)


def _reads(seed=1, n=600, length=100, genome_len=3000):
    """Reads from both strands of a random genome, 1% substitutions."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=genome_len).astype(np.uint8)
    reads = []
    for _ in range(n):
        s = int(rng.integers(0, genome_len - length))
        r = genome[s:s + length].copy()
        if rng.random() < 0.5:
            r = (3 - r)[::-1].copy()
        err = rng.random(length) < 0.01
        r[err] = (r[err] + 1) % 4
        reads.append(r)
    return reads


def _batches(batcher_mod, reads):
    b = batcher_mod.Batcher(K, ROWS, L)
    return [x for r in reads for x in b.add_read(r)] + list(b.flush())


@pytest.fixture(scope="module")
def closure_input():
    """The JAX package's spectrum of the reads, the same state as the
    port's Spectrum, and the port's collected nodes."""
    reads = _reads()
    sizing = jcfg.CounterSizing(
        k=K, qb=KEY_BITS - 8, hb=KEY_BITS, num_true_kmers=0,
        num_false_kmers=0, n_true_kmers=1, num_deNoise=0,
        ndistinct_for_deNoise=1 << 62, end_deNoise=False, fr=0.0)
    jspec, _ = jcounter.build_spectrum(
        iter(_batches(jfastq, reads)), sizing, capacity=1 << 16,
        buf_capacity=1 << 14,
        batch_cfg=jcfg.BatchConfig(reads_per_batch=ROWS, max_read_len=L))
    spec = sp.from_jax_planes(
        hi=np.asarray(jspec.hi), lo=np.asarray(jspec.lo),
        buf_hi=np.asarray(jspec.buf_hi), buf_lo=np.asarray(jspec.buf_lo),
        n_main=int(jspec.n_main), n_buf=int(jspec.n_buf),
        ndistinct=int(jspec.ndistinct), nelts=int(jspec.nelts), device=DEV)
    hi, lo, _ = contiger.collect_nodes(spec, iter(_batches(fastq, reads)), K,
                                       KEY_BITS, 2)
    return reads, jspec, spec, hi, lo


@pytest.fixture
def table_calls(monkeypatch):
    """Every build, append and probe of a node table: (kind, the table's
    id, its store's numpy words after the call, probe queries and
    answers)."""
    calls = []
    for kind in ("build", "append", "probe"):
        fn = getattr(nj.NodeTable, kind)

        def call(self, *a, _kind=kind, _fn=fn, **kw):
            out = _fn(self, *a, **kw)
            # copies: an append writes into the store in place
            rec = dict(kind=_kind, table=id(self), n=self.n_real,
                       hi=bits.to_u64_np(self.hi).copy(),
                       lo=bits.to_u64_np(self.lo).copy())
            if _kind == "probe":
                rec.update(q=[bits.to_u64_np(t) for t in a[:2]],
                           got=out.numpy())
            calls.append(rec)
            return out
        monkeypatch.setattr(nj.NodeTable, kind, call)
    return calls


def test_closure_rounds_probe_the_jax_padded_store(closure_input,
                                                   table_calls):
    _, jspec, spec, hi, lo = closure_input
    jstores = []
    jreal = jcontiger.phantom_candidates

    def jspy(*args, **kw):
        jstores.append((np.asarray(args[1]), np.asarray(args[2])))
        return jreal(*args, **kw)

    jcontiger.phantom_candidates = jspy
    try:
        jhi, jlo, jn = jcontiger.close_over_phantoms(
            jspec, bits.to_u64_np(hi), bits.to_u64_np(lo), K, KEY_BITS, 2)
    finally:
        jcontiger.phantom_candidates = jreal
    got_hi, got_lo, n = contiger.close_over_phantoms(spec, hi, lo, K,
                                                     KEY_BITS, 2)
    assert n == jn > 0
    np.testing.assert_array_equal(bits.to_u64_np(got_hi), jhi)
    np.testing.assert_array_equal(bits.to_u64_np(got_lo), jlo)
    probes = [c for c in table_calls if c["kind"] == "probe"]
    rounds = len(jstores)
    assert rounds >= 4 and len(probes) == rounds
    # one table: built once, every round that found phantoms appends them
    assert [c["kind"] for c in table_calls] == \
        ["build"] + ["probe", "append"] * (rounds - 1) + ["probe"]
    assert len({c["table"] for c in table_calls}) == 1
    for (sh, sl), c in zip(jstores, probes):
        np.testing.assert_array_equal(c["hi"], sh)
        np.testing.assert_array_equal(c["lo"], sl)
        np.testing.assert_array_equal(c["got"], _jax_join2(sh, sl, *c["q"]))


def test_contiger_shares_the_table_and_matches_jax(closure_input, tmp_path,
                                                   table_calls, monkeypatch):
    reads, jspec, spec, _, _ = closure_input
    joins = []
    real_join2 = kp.join2
    monkeypatch.setattr(kp, "join2",
                        lambda *a: joins.append(1) or real_join2(*a))
    params = dict(k=K, kmer_abundance_min=2)
    ref = jcontiger.assemble_unitigs_arrays(
        jspec, iter(_batches(jfastq, reads)), jcfg.ContigerParams(**params),
        KEY_BITS)
    got = contiger.assemble_unitigs_arrays(
        spec, iter(_batches(fastq, reads)), cfg.ContigerParams(**params),
        KEY_BITS)
    assert got.n == ref.n > 10
    for f in ("seq_codes", "offsets", "med", "after_ptr", "after_val",
              "before_ptr", "before_val"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), f)
    ref.write_fasta(str(tmp_path / "ref.fa"))
    got.write_fasta(str(tmp_path / "got.fa"))
    assert (tmp_path / "got.fa").read_bytes() == \
        (tmp_path / "ref.fa").read_bytes()
    # the closure's table, built once, answers the graph's probe too
    kinds = [c["kind"] for c in table_calls]
    rounds = kinds.count("append") + 1
    assert rounds >= 4 and kinds.count("build") == 1
    assert kinds.count("probe") == rounds + 1 and kinds[-1] == "probe"
    assert len({c["table"] for c in table_calls}) == 1 and not joins


def test_profile_node_join_counts_match_jax():
    assert prof_nj.main(["--device", DEV, "--log2-n", "12"]) == 0
    shapes = list(prof_nj.shapes(DEV, 12))
    assert list(prof_nj.LAST) == [s[0] for s in shapes]
    for name, th, tl, qh, ql in shapes:
        want = _jax_join2(*(bits.to_u64_np(t) for t in (th, tl, qh, ql)))
        r = prof_nj.LAST[name]
        assert (r["rows"], r["queries"]) == (th.numel(), qh.numel())
        assert r["found"] == int((want >= 0).sum()) > 0
