"""The port's Contiger and pipeline CLIs on the CPU against the JAX
package's: byte-identical ``unitigs.fa`` and ``contigs.fa``; both CLIs
running with JAX unimportable; and their refusal to fall back to the CPU
when CUDA is asked for and absent."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

import chip_smoke
from sh_assembly_tpu.cli import contiger as jcontiger_cli
from sh_assembly_tpu.cli import cqf_denoise as jcqf_cli
from sh_assembly_tpu.cli import pipeline as jpipeline_cli
from sh_assembly_tpu_torch.cli import contiger as contiger_cli
from sh_assembly_tpu_torch.cli import pipeline as pipeline_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READS = dict(genome_len=12_000, n_reads=1_200, read_len=150, sub_rate=0.004,
             n_rate=0.001, seed=3)


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    """15x of 150 bp reads from both strands of a 12 kbp genome, with
    substitutions and Ns."""
    d = tmp_path_factory.mktemp("reads150")
    chip_smoke.write_fastq(str(d / "reads.fastq"), **READS)
    return d


def _count_flags(workload, k):
    n_kmers = READS["n_reads"] * (READS["read_len"] - k + 1)
    return ["-k", str(k), "-n", str(READS["genome_len"]), "-N", str(n_kmers),
            "-e", str(READS["sub_rate"]),
            "-i", str(workload / "ReadFiles.txt")]


def _contiger_argv(workload, k, ser, out):
    return ["-k", str(k), "-i", str(workload / "ReadFiles.txt"),
            "-c", str(ser), "-o", str(out)]


def _pipeline_argv(workload, k, d, tag):
    return _count_flags(workload, k) + [
        "-o", str(d / f"contigs_{tag}.fa"),
        "--unitigs", str(d / f"unitigs_{tag}.fa")]


@pytest.mark.parametrize("k", [21, 47])
def test_unitigs_byte_identical_to_jax_contiger_cli(workload, tmp_path, k):
    ser = tmp_path / f"k{k}.ser"
    assert jcqf_cli.main(_count_flags(workload, k)
                         + ["--deNoise", "0", "-o", str(ser)]) == 0
    assert jcontiger_cli.main(
        _contiger_argv(workload, k, ser, tmp_path / "jax.fa")) == 0
    assert contiger_cli.main(
        _contiger_argv(workload, k, ser, tmp_path / "port.fa")
        + ["--device", "cpu"]) == 0
    ref = (tmp_path / "jax.fa").read_bytes()
    assert ref.count(b">") > 10
    assert (tmp_path / "port.fa").read_bytes() == ref


@pytest.mark.parametrize("k", [21, 47])
def test_contigs_byte_identical_to_jax_pipeline_cli(workload, tmp_path, k):
    assert jpipeline_cli.main(_pipeline_argv(workload, k, tmp_path,
                                             "jax")) == 0
    assert pipeline_cli.main(_pipeline_argv(workload, k, tmp_path, "port")
                             + ["--device", "cpu"]) == 0
    for f in ("unitigs", "contigs"):
        ref = (tmp_path / f"{f}_jax.fa").read_bytes()
        assert ref.count(b">") > 0, f
        assert (tmp_path / f"{f}_port.fa").read_bytes() == ref, f


def test_contiger_and_pipeline_run_without_jax(workload, tmp_path):
    """With `import jax` made to fail, the port's counting, Contiger and
    pipeline CLIs run, and neither jax nor the JAX package gets loaded."""
    k = 31
    ser = tmp_path / "nojax.ser"
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None  # any `import jax` now raises
        from sh_assembly_tpu_torch.cli import contiger, cqf_denoise, pipeline
        cpu = ["--device", "cpu"]
        assert cqf_denoise.main({_count_flags(workload, k)!r}
                                + ["-o", {str(ser)!r}] + cpu) == 0
        assert contiger.main({_contiger_argv(workload, k, ser,
                                             tmp_path / "u.fa")!r}
                             + cpu) == 0
        assert pipeline.main({_pipeline_argv(workload, k, tmp_path, "p")!r}
                             + cpu) == 0
        loaded = [m for m in sys.modules
                  if m == "sh_assembly_tpu" or m.startswith("sh_assembly_tpu.")
                  or (m.startswith("jax") and sys.modules[m] is not None)]
        assert not loaded, loaded
        print("NOJAX_OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "NOJAX_OK" in r.stdout
    for f in ("u.fa", "unitigs_p.fa", "contigs_p.fa"):
        assert (tmp_path / f).read_bytes().count(b">") > 0, f


def test_cuda_device_without_gpu_raises(workload, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cuda = ["--device", "cuda"]
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        contiger_cli.main(_contiger_argv(workload, 31, tmp_path / "x.ser",
                                         tmp_path / "u.fa") + cuda)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        pipeline_cli.main(_pipeline_argv(workload, 31, tmp_path, "x") + cuda)
    assert not list(tmp_path.iterdir())
