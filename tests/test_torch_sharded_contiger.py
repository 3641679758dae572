"""The port's sharded Contiger (``parallel/sharded_contiger.py`` over the
in-process back end, on the CPU) against the JAX package's on the 8-device
virtual CPU mesh: the ``ArrayUnitigs`` arrays bitwise at n = 4 and 8 (a
node's index is shard * cap + local in both), the set of unitigs equal to
the port's single-device run, the solid-seed filter, and the refusal of
an overflowing node store.  Tolerance: exact."""

import numpy as np
import pytest

from sh_assembly_tpu import config as jcfg
from sh_assembly_tpu.io import fastq as jfastq
from sh_assembly_tpu.parallel import sharded as jsharded
from sh_assembly_tpu.parallel import sharded_contiger as jsc_mod
from sh_assembly_tpu_torch import config as cfg
from sh_assembly_tpu_torch.io import fastq
from sh_assembly_tpu_torch.models import contiger, counter
from sh_assembly_tpu_torch.ops import spectrum as sp
from sh_assembly_tpu_torch.parallel import sharded, sharded_contiger
from sh_assembly_tpu_torch.utils import dna

from oracle import random_genome, reads_from_genome

DEV = "cpu"  # the port's functions default to the GPU
K, QB = 21, 12
B, L = 32, 80

ARRAYS = ("seq_codes", "offsets", "med", "after_ptr", "after_val",
          "before_ptr", "before_val", "mean")


def _batches(mod, reads):
    """Equal-row batches (the sharded path wants a fixed geometry)."""
    b = mod.Batcher(K, B, L)
    out = []
    for r in reads:
        out.extend(b.add_read(r))
    out.extend(b.flush())
    padded = []
    for x in out:
        codes, lengths = x.codes, x.lengths
        if codes.shape[0] < B:
            codes = np.pad(codes, ((0, B - codes.shape[0]), (0, 0)),
                           constant_values=5)
            lengths = np.pad(lengths, (0, B - len(lengths)))
        padded.append(mod.Batch(codes=codes, lengths=lengths,
                                n_rows=codes.shape[0]))
    return padded


def _counted(n, qb, reads):
    """The JAX and the port's sharded spectra of the same reads (step and
    merge per batch, as the JAX package's own tests build them)."""
    kw = dict(k=K, key_bits=qb + 8, local_capacity=8192,
              local_buf_capacity=8192)
    jsc = jsharded.ShardedCounter(mesh=jsharded.make_mesh(n), **kw)
    sc = sharded.ShardedCounter(mesh=sharded.make_mesh(n, DEV), **kw)
    jstep, jmerge = jsc.step_fn(), jsc.merge_fn()
    jspec, specs = jsc.init(), sc.init()
    for b in _batches(jfastq, reads):
        jspec = jmerge(jstep(jspec, *jsc.shard_batch(b.codes, b.lengths)))
        specs = sc.merge(sc.step(specs, *sc.shard_batch(b.codes, b.lengths)))
    return jsc, jspec, sc, specs


def _assert_arrays_equal(got, ref):
    assert got.n == ref.n and got.n_palindromes == ref.n_palindromes
    for f in ARRAYS:
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                      err_msg=f)


def _unitig_set(au):
    return {dna.canonical(au.seq(i)) for i in range(au.n)}


@pytest.fixture(scope="module")
def reads():
    rng = np.random.default_rng(2038074761)
    genome = random_genome(rng, 2500)
    return reads_from_genome(rng, genome, 700, 72, error_rate=0.015)


@pytest.mark.parametrize("n", [4, 8])
def test_sharded_contiger_matches_jax(reads, n):
    jsc, jspec, sc, specs = _counted(n, QB, reads)
    params = cfg.ContigerParams(k=K, kmer_abundance_min=2)
    ref = jsc_mod.assemble_unitigs_sharded(
        jsc, jspec, _batches(jfastq, reads),
        jcfg.ContigerParams(k=K, kmer_abundance_min=2))
    got = sharded_contiger.assemble_unitigs_sharded(
        sc, specs, _batches(fastq, reads), params)
    _assert_arrays_equal(got, ref)
    assert got.n > 1

    # the port's single-device run on the same reads: the same unitigs,
    # numbered otherwise
    sizing = cfg.CounterSizing(
        k=K, qb=QB, hb=QB + 8, num_true_kmers=0, num_false_kmers=0,
        n_true_kmers=1, num_deNoise=0, ndistinct_for_deNoise=1 << 62,
        end_deNoise=False, fr=0.0)
    spec1, _ = counter.build_spectrum(
        iter(_batches(fastq, reads)), sizing, capacity=1 << 15,
        buf_capacity=1 << 15,
        batch_cfg=cfg.BatchConfig(reads_per_batch=B, max_read_len=L),
        device=DEV)
    single = contiger.assemble_unitigs_arrays(
        spec1, iter(_batches(fastq, reads)), params, key_bits=QB + 8)
    assert _unitig_set(got) == _unitig_set(single)


def test_sharded_contiger_solid_filter():
    """A second genome read three times has no solid seed (-x 5): none of
    its unitigs is kept; the arrays equal the JAX run's."""
    qb, n = 20, 4
    rng = np.random.default_rng(11)
    genome_a = random_genome(rng, 1200)
    genome_b = random_genome(rng, 400)
    reads = reads_from_genome(rng, genome_a, 500, 72) + [genome_b] * 3
    jsc, jspec, sc, specs = _counted(n, qb, reads)
    kw = dict(k=K, kmer_abundance_min=2, solid_kmer_abundance_min=5)
    ref = jsc_mod.assemble_unitigs_sharded(
        jsc, jspec, _batches(jfastq, reads), jcfg.ContigerParams(**kw))
    got = sharded_contiger.assemble_unitigs_sharded(
        sc, specs, _batches(fastq, reads), cfg.ContigerParams(**kw))
    _assert_arrays_equal(got, ref)
    assert got.n > 0
    for i in range(got.n):
        s = got.seq(i)
        assert s not in genome_b and dna.revcomp(s) not in genome_b


def test_sharded_contiger_overflow_raises(reads):
    """A node store too small for a shard's nodes refuses to go on."""
    _, _, sc, specs = _counted(4, QB, reads)
    with pytest.raises(RuntimeError, match="node store overflow"):
        sharded_contiger.assemble_unitigs_sharded(
            sc, specs, _batches(fastq, reads),
            cfg.ContigerParams(k=K, kmer_abundance_min=2),
            node_cap_local=64)


def test_node_cap_holds_the_busiest_shard(tmp_path):
    """Canonical k-mers skew to low top bits, so shard 0 holds ~7/16 of the
    nodes at n = 4: the JAX layer's capacity rule (a 1/n share) overflows
    on a 20 kbp genome, the port's (``node_cap_for``) holds it, and the
    unitigs equal the single-device run's."""
    import chip_smoke
    from sh_assembly_tpu_torch.parallel import driver

    chip_smoke.write_fastq(str(tmp_path / "reads.fastq"), genome_len=20_000,
                           n_reads=6000, read_len=100, sub_rate=0.01,
                           n_rate=0.001, seed=3)
    files = [str(tmp_path / "reads.fastq")]
    k, n = 31, 4
    sizing = cfg.CounterSizing(
        k=k, qb=18, hb=26, num_true_kmers=0, num_false_kmers=0,
        n_true_kmers=1, num_deNoise=0, ndistinct_for_deNoise=1 << 62,
        end_deNoise=True, fr=0.0)
    bc = cfg.BatchConfig(reads_per_batch=512, max_read_len=104)
    sc, specs, keys, counts, _ = driver.count_sharded(
        files, sizing, n_mesh=n, batch_cfg=bc, super_batch=2, device=DEV)
    params = cfg.ContigerParams(k=k)

    def stream():
        from sh_assembly_tpu_torch.io import native

        return native.packed_batches_from_files(files, k, "auto",
                                                bc.reads_per_batch, 104)

    nd = max(sum(s.ndistinct for s in specs), 1024)
    jax_cap = 1 << int(np.ceil(np.log2(nd // n + nd // (8 * n) + 1024)))
    assert sharded_contiger.node_cap_for(sc.mesh, specs) > jax_cap
    with pytest.raises(RuntimeError, match="node store overflow"):
        sharded_contiger.assemble_unitigs_sharded(
            sc, specs, stream(), params, node_cap_local=jax_cap)
    got = sharded_contiger.assemble_unitigs_sharded(sc, specs, stream(),
                                                    params)
    spec1 = sp.from_host(keys, counts, 1 << 16, 1 << 10, sizing.hb,
                         device=DEV)
    single = contiger.assemble_unitigs_arrays(spec1, stream(), params,
                                              sizing.hb)
    assert got.n > 100 and _unitig_set(got) == _unitig_set(single)
