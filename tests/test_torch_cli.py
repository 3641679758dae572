"""The port's CQF-deNoise CLI on the CPU: byte-identical .ser files against
the JAX package's CLI and against the reference's own compiled hot loop
(tests/ref_harness/ref_count.cpp, skipped where it cannot be built), an
import check that the port runs without JAX, and the refusal to fall back
to the CPU when CUDA is asked for and absent."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

from sh_assembly_tpu import config as jcfg
from sh_assembly_tpu.cli import cqf_denoise as jcli
from sh_assembly_tpu_torch.cli import cqf_denoise as cli

# the synthetic FASTQ and the reference-harness build of the JAX
# package's own hot-loop parity test
from test_ref_hotloop import ref_count, workload  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _argv(workload, out, extra):
    return ["-k", "28", "-n", "8000", "-N", extra.get("N", "64000"),
            "-e", "0.012", "-i", str(workload / "ReadFiles.txt"),
            "-o", str(out)] + extra.get("flags", [])


@pytest.mark.parametrize("extra", [
    {"flags": ["--deNoise", "0"]},
    {"flags": ["--deNoise", "0", "--endDeNoise"]},
    # triggers (17178 and 18489 distinct) below the stream's ~21k distinct
    # keys: the threshold sweep fires at the end of the stream
    {"flags": ["--deNoise", "1"]},
    {"N": "256000", "flags": ["--endDeNoise"]},
], ids=["denoise0", "end_denoise", "denoise1", "default_rounds"])
def test_ser_byte_identical_to_jax_cli(workload, tmp_path, extra):  # noqa: F811
    assert jcli.main(_argv(workload, tmp_path / "jax.ser", extra)) == 0
    assert cli.main(_argv(workload, tmp_path / "port.ser", extra)
                    + ["--device", "cpu"]) == 0
    ref = (tmp_path / "jax.ser").read_bytes()
    assert (tmp_path / "port.ser").read_bytes() == ref


def test_overflow_raises_like_jax_cli(workload, tmp_path):  # noqa: F811
    # -n 2000 sizes the store at 2^14 slots, below the ~21k distinct keys
    argv = _argv(workload, tmp_path / "o.ser", {"flags": ["--deNoise", "1"]})
    argv[argv.index("-n") + 1] = "2000"
    with pytest.raises(RuntimeError, match="overflow"):
        jcli.main(argv)
    with pytest.raises(RuntimeError, match="overflow"):
        cli.main(argv + ["--device", "cpu"])


@pytest.mark.parametrize("end_denoise", [False, True])
def test_ser_byte_identical_to_reference_hot_loop(ref_count, workload,  # noqa: F811
                                                  tmp_path, end_denoise):
    k, n_true, total = 28, 8000, 64000
    sizing = jcfg.size_counter(k=k, n_true_kmers=n_true, total_kmers=total,
                               alpha=0.012, num_deNoise=0,
                               end_deNoise=end_denoise)
    ref_ser = tmp_path / "ref.ser"
    args = [ref_count, str(sizing.qb), str(sizing.hb), str(k), str(ref_ser)]
    if end_denoise:
        args.append("--endDeNoise")
    with open(workload / "reads.fastq", "rb") as f:
        subprocess.run(args, stdin=f, check=True, capture_output=True)
    flags = ["--deNoise", "0"] + (["--endDeNoise"] if end_denoise else [])
    ours = tmp_path / "port.ser"
    assert cli.main(_argv(workload, ours, {"flags": flags})
                    + ["--device", "cpu"]) == 0
    assert ours.read_bytes() == ref_ser.read_bytes()


def test_port_runs_without_jax(workload, tmp_path):  # noqa: F811
    """With `import jax` made to fail, the port's CLI imports and counts
    (single store and --mesh 2, the same bytes), its tools, profiling
    entry points, the bench, the mesh layer's dry run and set operations
    run, and neither jax nor the JAX package gets loaded."""
    out = tmp_path / "nojax.ser"
    mesh_out = tmp_path / "nojax_mesh.ser"
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None  # any `import jax` now raises
        from sh_assembly_tpu_torch.cli import cqf_denoise
        rc = cqf_denoise.main({_argv(workload, out, {"flags": ["--deNoise", "0"]})!r}
                              + ["--device", "cpu"])
        assert rc == 0, rc
        # the tools and the library surface off the main path
        from sh_assembly_tpu_torch.cli import compare_contigs, cqf_dump, minia
        from sh_assembly_tpu_torch.ops import blocksort_cuda, spectrum
        from sh_assembly_tpu_torch.profile import blocksort, kernels, mesh, sort
        # the mesh layer, its CLI path and its entry points
        from sh_assembly_tpu_torch.parallel import collectives, driver, \
            dryrun, multihost, sharded, sharded_contiger
        rc = cqf_denoise.main({_argv(workload, mesh_out, {"flags": ["--deNoise", "0"]})!r}
                              + ["--device", "cpu", "--mesh", "2"])
        assert rc == 0, rc
        assert open({str(out)!r}, "rb").read() == open({str(mesh_out)!r}, "rb").read()
        assert dryrun.dryrun_multichip(2, "cpu")["unitigs"] > 0
        assert mesh.main(["--device", "cpu", "--n", "2", "--log2-capacity",
                          "14", "--rows-per-shard", "8", "--reps", "1"]) == 0
        assert cqf_dump.main([{str(out)!r}, "--meta-only"]) == 0
        assert blocksort.main(["--device", "cpu", "--log2-n", "12",
                               "--log2-w", "8"]) == 0
        assert sort.main(["--device", "cpu", "--log2-n", "12"]) == 0
        assert kernels.main(["--device", "cpu", "--log2-capacity", "12"]) == 0
        from sh_assembly_tpu_torch.profile import collect, entry, hot, stage2
        assert hot.main(["--device", "cpu", "--log2-capacity", "12",
                         "--log2-buf", "14", "--rows", "16", "--stacks", "2",
                         "--reps", "1"]) == 0
        assert collect.main(["--device", "cpu", "--genome-len", "3000",
                             "--reads", "300", "--batch", "128"]) == 0
        assert stage2.main(["--device", "cpu", "--log2-n", "10",
                            "--log2-capacity", "13", "--log2-buf", "11"]) == 0
        assert entry.main(["--device", "cpu"]) == 0
        # the bench: its primary section alone (a deadline of 0 skips the rest)
        import os
        os.environ["SH_BENCH_DEADLINE"] = "0"
        from sh_assembly_tpu_torch import bench
        assert bench.main(["--device", "cpu", "--log2-capacity", "16",
                           "--log2-buf", "13", "--rows", "8",
                           "--stacks", "2"]) == 0
        a = spectrum.from_host([1, 2, 3], [4, 5, 6], 8, 8, 30, device="cpu")
        assert int(spectrum.inner_product(a, spectrum.union(a, a, 30), 30)) \
            == 2 * (16 + 25 + 36)
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
    assert out.stat().st_size > 0


def test_cuda_device_without_gpu_raises(workload, tmp_path, monkeypatch):  # noqa: F811
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        cli.main(_argv(workload, tmp_path / "x.ser", {}) + ["--device", "cuda"])
    assert not (tmp_path / "x.ser").exists()
