"""The port's tools on the CPU: ``cli.cqf_dump``, ``cli.minia`` and
``cli.compare_contigs`` against the JAX package's CLIs on the same files
(stdout, the stderr header and summary lines, and output files byte for
byte), and the two profiling entry points at a tiny size."""

import re

import numpy as np
import pytest
import torch

import chip_smoke
from sh_assembly_tpu.cli import compare_contigs as jcompare
from sh_assembly_tpu.cli import cqf_dump as jdump
from sh_assembly_tpu.cli import minia as jminia
from sh_assembly_tpu_torch.cli import compare_contigs, cqf_dump, minia
from sh_assembly_tpu_torch.cli import pipeline as pipeline_cli
from sh_assembly_tpu_torch.ops import bits
from sh_assembly_tpu_torch.profile import blocksort as pblocksort
from sh_assembly_tpu_torch.profile import kernels as pkernels
from sh_assembly_tpu_torch.profile import sort as psort

K = 21
READS = dict(genome_len=12_000, n_reads=1_200, read_len=150, sub_rate=0.004,
             n_rate=0.001, seed=3)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A ``.ser``, ``unitigs.fa`` and ``contigs.fa`` from the port's
    pipeline on 15x of 150 bp reads of a 12 kbp genome."""
    d = tmp_path_factory.mktemp("tools")
    chip_smoke.write_fastq(str(d / "reads.fastq"), **READS)
    n_kmers = READS["n_reads"] * (READS["read_len"] - K + 1)
    assert pipeline_cli.main([
        "-k", str(K), "-n", str(READS["genome_len"]), "-N", str(n_kmers),
        "-e", str(READS["sub_rate"]), "-i", str(d / "ReadFiles.txt"),
        "-o", str(d / "contigs.fa"), "--unitigs", str(d / "unitigs.fa"),
        "--save-cqf", str(d / "k.ser"), "--device", "cpu"]) == 0
    return d


def _log_lines(err: str) -> list[str]:
    """Log lines without their time stamps and without the timing line."""
    lines = [re.sub(r"^\[[^\]]*\] ", "", ln) for ln in err.splitlines()]
    return [ln for ln in lines if "wrote" not in ln]


@pytest.mark.parametrize("extra", [["--meta-only"], ["--limit", "7"], []],
                         ids=["meta_only", "limit", "all"])
def test_cqf_dump_matches_jax_cli(files, capsys, extra):
    argv = [str(files / "k.ser")] + extra
    assert jdump.main(argv) == 0
    ref = capsys.readouterr()
    assert cqf_dump.main(argv) == 0
    got = capsys.readouterr()
    assert got.out == ref.out and got.err == ref.err
    assert ref.err.count("\n") == 2 and "nslots=" in ref.err
    if extra != ["--meta-only"]:
        assert len(ref.out.splitlines()) >= 7


@pytest.mark.parametrize("extra", [[], ["-no-tip-removal"],
                                   ["-no-bulge-removal"],
                                   ["-no-ec-removal"]],
                         ids=["all", "no_tip", "no_bulge", "no_ec"])
def test_minia_matches_jax_cli(files, tmp_path, capsys, extra):
    argv = ["-kmer-size", str(K), "-in", str(files / "unitigs.fa"),
            "-unitig"] + extra
    assert jminia.main(argv + ["-out", str(tmp_path / "jax.fa")]) == 0
    ref = capsys.readouterr()
    assert minia.main(argv + ["-out", str(tmp_path / "port.fa")]) == 0
    got = capsys.readouterr()
    data = (tmp_path / "jax.fa").read_bytes()
    assert data.count(b">") >= 1
    assert (tmp_path / "port.fa").read_bytes() == data
    assert got.out == ref.out
    assert _log_lines(got.err) == _log_lines(ref.err)
    assert any("removed tips=" in ln for ln in _log_lines(got.err))


def test_minia_default_output_name_and_pipeline_contigs(files, capsys):
    """Without -out the contigs go to <in>.contigs.fa; they hold the
    pipeline's contigs as a set of sequences."""
    assert minia.main(["-kmer-size", str(K), "-in",
                       str(files / "unitigs.fa")]) == 0
    out = files / "unitigs.contigs.fa"
    assert out.exists()
    capsys.readouterr()
    assert compare_contigs.main(["-k", str(K), str(out),
                                 str(files / "contigs.fa")]) == 0
    assert "(1.0000 jaccard)" in capsys.readouterr().out.splitlines()[0]


@pytest.mark.parametrize("pair,rc", [(("contigs.fa", "contigs.fa"), 0),
                                     (("contigs.fa", "unitigs.fa"), 1)],
                         ids=["same", "different"])
def test_compare_contigs_matches_jax_cli(files, capsys, pair, rc):
    argv = ["-k", str(K)] + [str(files / f) for f in pair]
    assert jcompare.main(argv) == rc
    ref = capsys.readouterr()
    assert compare_contigs.main(argv) == rc
    got = capsys.readouterr()
    assert got.out == ref.out and got.err == ref.err
    assert len(ref.out.splitlines()) == 4


def test_profile_blocksort_main_on_cpu(capsys):
    assert pblocksort.main(["--device", "cpu", "--log2-n", "14",
                            "--log2-w", "10"]) == 0
    err = capsys.readouterr().err
    assert "blocksort W=2^10" in err and "55 stages" in err
    assert "correct: True" in err
    last = pblocksort.LAST
    assert last["n"] == 1 << 14 and last["w"] == 1 << 10
    assert last["ms"] > 0 and last["plain_ms"] > 0
    x = pblocksort.make_input(14)
    assert last["chk"] == int(np.sort(x[:1 << 10])[0])
    with pytest.raises(ValueError):
        pblocksort.main(["--device", "cpu", "--log2-n", "10",
                         "--log2-w", "10"])


def test_profile_sort_main_on_cpu(capsys):
    assert psort.main(["--device", "cpu", "--log2-n", "12"]) == 0
    err = capsys.readouterr().err
    for name, _ in psort.VARIANTS:
        assert f"{name} 2^12" in err
    times = psort.run(torch.device("cpu"), 12)
    assert len(times) == 8 and all(v > 0 for v in times.values())
    with pytest.raises(ValueError):
        psort.main(["--device", "cpu", "--log2-n", "11"])


def test_profile_kernels_main_on_cpu(capsys):
    """K1 to K4 at a CPU size: every row is timed (K1 into a fresh and a
    reused output) and the generated state is what the rows say."""
    assert pkernels.main(["--device", "cpu", "--log2-capacity", "14"]) == 0
    err = capsys.readouterr().err
    for row in ("K1 merge, fresh output", "K1 merge, reused output",
                "K1 sweep, fresh output", "K1 sweep, reused output",
                "K2 4608 probes", "K2 128 probes", "K2 8 probes",
                "K2 8192 probes", "torch.searchsorted 4608 probes",
                "K3 small shape, 366 stored + 128",
                "K3 flush shape: ", "K3 empty store: ",
                "K4 4096 values, windows of 128",
                "torch.sort rows [32, 128]"):
        assert row in err, row
    assert len([ln for ln in err.splitlines() if " ms" in ln]) == 16
    store, buf, n, kb, C = pkernels.big_case("cpu", n_live=3000, n_buf=4096,
                                             capacity=1 << 14)
    assert C == 1 << 14 and kb == 37 and 2900 < n <= 3000
    live = store[:n]
    assert bool((bits.flip(live)[1:] > bits.flip(live)[:-1]).all())
    assert bool((store[n:] == -1).all())
    assert bool((bits.flip(buf)[1:] >= bits.flip(buf)[:-1]).all())
    q = pkernels.probe_keys(store, n, kb, 640)
    assert q.numel() == 640 and bool((q[-10:] == -1).all())
    assert bool((q[1:630] >= q[:629]).all())
    res = pkernels.run(torch.device("cpu"), 14)
    assert all(v > 0 for v in res.values())


def test_profile_sort_variants_sort():
    """Every variant's output against numpy on the script's own input."""
    hi_np, lo_np = psort.make_input(12)
    hi = bits.flip32(torch.from_numpy(hi_np.view(np.int32)))
    lo = bits.flip32(torch.from_numpy(lo_np.view(np.int32)))
    out = {name.split()[0]: fn(hi, lo) for name, fn in psort.VARIANTS}

    def u32(t):
        return bits.flip32(t).numpy().view(np.uint32)

    word = (hi_np.astype(np.uint64) << np.uint64(32)) | lo_np
    ref = np.sort(word)
    np.testing.assert_array_equal(
        (u32(out["A"][0]).astype(np.uint64) << np.uint64(32))
        | u32(out["A"][1]), ref)
    np.testing.assert_array_equal(bits.to_u64_np(bits.flip(out["B"][0])), ref)
    np.testing.assert_array_equal(u32(out["C"][0]), np.sort(lo_np))
    for v, g in (("D", 256), ("E", 64), ("F", 1024), ("H", 4096)):
        np.testing.assert_array_equal(
            u32(out[v][0]), np.sort(lo_np.reshape(g, -1), axis=1))
    np.testing.assert_array_equal(
        (u32(out["G"][0]).astype(np.uint64) << np.uint64(32))
        | u32(out["G"][1]), np.sort(word.reshape(256, -1), axis=1))


def _sorted_stream(hi, lo, nf):
    """(hi, lo, nflag) ascends, hi and lo compared unsigned."""
    h, l_ = bits.to_u64_np(hi), bits.to_u64_np(lo)
    key = list(zip(h.tolist(), l_.tolist(), nf.tolist()))
    return key == sorted(key)


def test_profile_kernels_flush_shape_is_what_it_says():
    """The generated flush: as many candidates, solid ones, distinct ones
    and stored ones as asked for, sorted, the sentinels last; the real
    size is the measured flush."""
    f = pkernels.FLUSH
    assert f["cap"] == 1 << 24 and f["n_b"] == 59_768_832
    assert f["n_hit"] <= f["n_distinct"] <= f["n_solid"] <= f["n_b"]
    assert f["n_store"] + f["n_distinct"] - f["n_hit"] < f["cap"]
    shape = dict(n_store=700, cap=1024, n_b=4000, n_solid=3300,
                 n_distinct=800, n_hit=650)
    a_hi, a_lo, a_nf, na, b_hi, b_lo, b_nf, cap = pkernels.k3_flush_case(
        "cpu", **shape)
    assert (na, cap, b_hi.numel()) == (700, 1024, 4000)
    assert _sorted_stream(a_hi[:na], a_lo[:na], a_nf[:na])
    assert _sorted_stream(b_hi, b_lo, b_nf)
    assert bool((a_hi[na:] == -1).all()) and bool((a_nf[na:] == 1).all())
    solid = ~((b_hi == -1) & (b_lo == -1))
    assert int(solid.sum()) == 3300 and bool(solid[:3300].all())
    assert bool((b_nf[3300:] == 1).all())
    pairs = set(zip(b_hi[:3300].tolist(), b_lo[:3300].tolist()))
    stored = set(zip(a_hi[:na].tolist(), a_lo[:na].tolist()))
    assert len(pairs) == 800 and len(pairs & stored) == 650
    o_hi, _, o_nf, n_live = pkernels.m3.merge128(a_hi, a_lo, a_nf, na, b_hi,
                                                 b_lo, b_nf, cap)
    assert int(n_live) == 700 + 150 and 0 < int((o_nf == 0).sum()) < 850
    # the small shape: few copies, a quarter of sentinels
    *_, s_hi, s_lo, s_nf, _ = pkernels.k3_big_case("cpu", n_store=500,
                                                   cap=1024, n_b=400)
    assert _sorted_stream(s_hi, s_lo, s_nf)
    assert int(((s_hi == -1) & (s_lo == -1)).sum()) == 100


@pytest.mark.parametrize("mod", [pblocksort, psort, pkernels])
def test_profile_main_refuses_cuda_without_gpu(mod, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        mod.main([])  # the default device is the GPU
