"""The port's bench (``sh_assembly_tpu_torch/bench.py``) at a CPU size
behind its geometry flags.

(a) ``main`` prints the end-to-end JSON line and then the primary one,
    last, with their keys; (b) its end-to-end section writes the same
    ``unitigs.fa`` and ``contigs.fa`` as the JAX package's pipeline CLI on
    the same FASTQ and flags (tolerance: none, bytes); (c) the loaded
    counting section's store, after the fill and one timed window, equals
    a numpy count of every key it inserted (the reads' keys hashed by the
    JAX package), with the fill's sweep dropping the keys whose total is 1
    and counts saturated at ``count_cap``; (d) a deadline of 0 skips every
    optional section and still prints the primary line; (e) a K1 that
    disagrees with the plain twin raises, in the section and out of
    ``main``."""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sh_assembly_tpu.cli import pipeline as jpipeline
from sh_assembly_tpu.ops import nthash as jnthash
from sh_assembly_tpu.ops import packio as jpackio
from sh_assembly_tpu_torch import bench
from sh_assembly_tpu_torch.ops import merge_cuda, spectrum as sp

DEV = "cpu"  # the bench defaults to the GPU

QB, LOG2_BUF, ROWS, STACKS = 18, 14, 16, 2
E2E_GENOME, E2E_READS = 20_000, 6_000  # 30x of 100 bp
CPU_SIZE = ["--device", DEV, "--log2-capacity", str(QB), "--log2-buf",
            str(LOG2_BUF), "--rows", str(ROWS), "--stacks", str(STACKS),
            "--stage2-genome", "4000", "--e2e-genome", str(E2E_GENOME),
            "--feed-reads", "300"]
OPTIONAL = ("roofline", "identity", "stage2", "mesh ratio", "end-to-end",
            "feed-included")


def test_main_prints_e2e_then_primary_last(capsys, monkeypatch):
    monkeypatch.setenv("SH_BENCH_FULL", "1")
    monkeypatch.delenv("SH_BENCH_DEADLINE", raising=False)
    assert bench.main(CPU_SIZE) == 0
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    assert len(lines) == 2
    primary, e2e = json.loads(lines[-1]), json.loads(lines[-2])
    assert primary["metric"] == bench.PRIMARY
    assert primary["unit"] == "kmers/s" and primary["value"] > 0
    assert primary["merges"] >= 2
    # no reference sources here: the literature anchor
    assert primary["vs_baseline"] == round(
        primary["value"] / bench.LITERATURE_ANCHOR, 3)
    assert primary["baseline_source"].startswith("literature")
    assert e2e["metric"] == bench.E2E and e2e["warm"] is True
    assert e2e["vs_baseline"] == 0.0
    assert e2e["baseline_source"].startswith("unmeasured")
    assert e2e["value"] > 0 and e2e["cold_s"] > 0
    assert "skipped" not in out.err and bench.LAST["skipped"] == []
    assert all(name in bench.LAST for name in OPTIONAL)
    # on the CPU there is no kernel to hold against the plain twin
    assert bench.LAST["identity"] == "no kernel"
    assert "no kernel on cpu; nothing compared" in out.err
    assert bench.LAST["feed-included"]["kmers"] == 4 * 300 * (100 - 47 + 1)


def test_end_to_end_matches_jax_pipeline(tmp_path):
    port, ref = tmp_path / "port", tmp_path / "jax"
    port.mkdir()
    ref.mkdir()
    res = bench.end_to_end(DEV, str(port), E2E_GENOME)
    assert res["warm"] is True
    fq = bench.write_e2e_reads(str(ref), E2E_GENOME, E2E_READS)
    assert open(fq, "rb").read() == (port / "reads.fastq").read_bytes()
    total = E2E_READS * (100 - bench.K + 1)
    assert jpipeline.main(bench.e2e_argv(str(ref), E2E_GENOME, total, 0)) \
        == 0
    for name in ("unitigs", "contigs"):
        want = (ref / f"{name}0.fa").read_bytes()
        assert want.count(b">") > 0
        for run in range(2):
            assert (port / f"{name}{run}.fa").read_bytes() == want, \
                (name, run)


def _group_sum(keys: np.ndarray, counts: np.ndarray):
    uk, inv = np.unique(keys, return_inverse=True)
    return uk, np.bincount(inv, weights=counts).astype(np.int64)


def test_loaded_counting_counts_what_it_inserts():
    kb = QB + 8
    C, BC = 1 << QB, 1 << LOG2_BUF
    W = bench.L - bench.K + 1
    n_supers = int(2.2 * BC / (STACKS * ROWS * W)) + 1
    rng, genome = bench.make_genome()
    supers = bench.make_stacks(rng, genome, n_supers, STACKS, ROWS, DEV)
    spec = bench.fill(sp.make(C, BC, DEV), kb)
    assert 0.45 < spec.ndistinct / C < 0.55
    spec, merges, _ = bench.count_window(spec, supers, kb)
    assert merges >= 2
    keys, counts, _ = sp.to_host(sp.merge(spec, kb), kb)

    n, pieces = bench.fill_pieces(C, BC)
    draws = [bench.rand_keys(DEV, i, n, kb).numpy().astype(np.uint64)
             for i in range(pieces)]
    fk, fc = np.unique(np.concatenate(draws + draws[:pieces // 2]),
                       return_counts=True)
    # the last merge of the fill sweeps: keys whose total is 1 go
    fk, fc = fk[fc >= 2], fc[fc >= 2]
    read_keys = []
    for pk, nm, ln in supers:
        for s in range(STACKS):
            codes = jpackio.unpack(jnp.asarray(pk[s].numpy()),
                                   jnp.asarray(nm[s].numpy()), bench.L)
            k, v = jnthash.windowed_canonical(
                codes, jnp.asarray(ln[s].numpy()), bench.K)
            read_keys.append(np.asarray(k)[np.asarray(v)])
    rk = np.concatenate(read_keys) & np.uint64((1 << kb) - 1)
    assert rk.size == n_supers * STACKS * ROWS * W
    want_k, want_c = _group_sum(np.concatenate([fk, rk]),
                                np.concatenate([fc, np.ones(rk.size)]))
    np.testing.assert_array_equal(keys, want_k)
    np.testing.assert_array_equal(counts,
                                  np.minimum(want_c, sp.count_cap(kb)))


def test_deadline_skips_every_optional_section(capsys, monkeypatch):
    monkeypatch.setenv("SH_BENCH_DEADLINE", "0")
    monkeypatch.setenv("SH_BENCH_FULL", "1")
    assert bench.main(CPU_SIZE) == 0
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    assert len(lines) == 1  # no end-to-end line
    assert json.loads(lines[0])["metric"] == bench.PRIMARY
    for name in OPTIONAL:
        assert f"# {name} skipped: bench deadline" in out.err
    assert bench.LAST["skipped"] == list(OPTIONAL)


def _flip_one_count_bit(*a, **kw):
    """A stand-in for K1 that returns the plain result with the lowest
    count bit of its first entry flipped."""
    out, n_live, n_dropped = merge_cuda.merge_dedup_plain(*a, **kw)
    out = out.clone()
    out[0] ^= 1
    return out, n_live, n_dropped


def test_identity_mismatch_raises():
    assert bench.k1_identity(DEV, merge_cuda.merge_dedup_plain, 12) == "OK"
    with pytest.raises(RuntimeError, match="K1/plain merge mismatch"):
        bench.k1_identity(DEV, _flip_one_count_bit, 12)


def test_identity_mismatch_fails_main(capsys, monkeypatch):
    monkeypatch.delenv("SH_BENCH_DEADLINE", raising=False)
    monkeypatch.setattr(bench, "k1_kernel", lambda device: _flip_one_count_bit)
    with pytest.raises(RuntimeError, match="K1/plain merge mismatch"):
        bench.main(CPU_SIZE)
    out = capsys.readouterr()
    assert out.out == ""  # no JSON line
    assert "MISMATCH" in out.err


def test_defaults_to_cuda(monkeypatch):
    assert bench.make_parser().parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        bench.main([])


def test_reference_dir_unset_gives_fallbacks(monkeypatch, tmp_path):
    monkeypatch.setattr(bench, "REF", "")
    assert bench.measure_cpu_baseline() == (
        bench.LITERATURE_ANCHOR, "literature (harness build failed)")
    assert bench.measure_ref_e2e_baseline(str(tmp_path / "x.fastq"), 47, 1) \
        == (0.0, "unmeasured (harness build failed)")
    monkeypatch.setattr(bench, "REF", str(tmp_path / "absent"))
    assert bench._build_ref("ref_count.cpp", "x") is None
    assert os.listdir(tmp_path) == []
