"""The port's mesh path through its user entry points, on the CPU: the
``--mesh 8`` CLIs against the JAX package's ``--mesh 8`` CLIs on the
8-device virtual CPU mesh (the same ``.ser`` and ``unitigs.fa`` bytes),
against the port's single-device CLI, ``driver.count_sharded`` against the
oracle and, with deNoise sweeps firing mid-stream, against the JAX
driver.  Tolerance: exact."""

import numpy as np
import pytest

from sh_assembly_tpu import config as jcfg
from sh_assembly_tpu.cli import contiger as jcontiger_cli
from sh_assembly_tpu.cli import cqf_denoise as jcli
from sh_assembly_tpu.parallel import driver as jdriver
from sh_assembly_tpu_torch import config as cfg
from sh_assembly_tpu_torch.cli import contiger as contiger_cli
from sh_assembly_tpu_torch.cli import cqf_denoise as cli
from sh_assembly_tpu_torch.parallel import driver

from oracle import oracle_count, random_genome, reads_from_genome

DEV = "cpu"  # the port's functions default to the GPU


def write_fastq(path, reads):
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(2038074761)
    k = 21
    genome = random_genome(rng, 4000)
    reads = reads_from_genome(rng, genome, 1200, 80, error_rate=0.01)
    fq = d / "reads.fastq"
    write_fastq(fq, reads)
    lst = d / "ReadFiles.txt"
    lst.write_text("reads.fastq\n")
    return k, reads, str(fq), str(lst), d


def _sizing(mod, k, rounds=0, threshold=1 << 62, qb=18):
    return mod.CounterSizing(
        k=k, qb=qb, hb=qb + 8, num_true_kmers=0, num_false_kmers=0,
        n_true_kmers=1, num_deNoise=rounds, ndistinct_for_deNoise=threshold,
        end_deNoise=False, fr=0.0)


def test_mesh_clis_match_jax_and_single_device(dataset):
    """cqf_denoise --mesh 8: the JAX CLI's bytes and the port's
    single-device bytes; contiger --mesh 8 on that .ser: the JAX CLI's
    unitigs.fa."""
    k, reads, fq, lst, d = dataset
    n_kmers = sum(max(len(r) - k + 1, 0) for r in reads)
    args = ["-k", str(k), "-n", "20000", "-N", str(n_kmers), "-e", "0.01",
            "--deNoise", "0", "-i", lst]
    out = {name: str(d / f"{name}.ser") for name in ("jax8", "port8", "port1")}
    assert jcli.main(args + ["-o", out["jax8"], "--mesh", "8"]) == 0
    assert cli.main(args + ["-o", out["port8"], "--mesh", "8",
                            "--device", DEV]) == 0
    assert cli.main(args + ["-o", out["port1"], "--device", DEV]) == 0
    ser = {name: open(p, "rb").read() for name, p in out.items()}
    assert ser["port8"] == ser["jax8"] == ser["port1"]

    cargs = ["-k", str(k), "-i", lst, "-c", out["port8"], "--mesh", "8"]
    assert jcontiger_cli.main(cargs + ["-o", str(d / "jax8.fa")]) == 0
    assert contiger_cli.main(cargs + ["-o", str(d / "port8.fa"),
                                      "--device", DEV]) == 0
    got = (d / "port8.fa").read_bytes()
    assert got == (d / "jax8.fa").read_bytes()
    assert got.count(b">") > 1


def test_count_sharded_matches_oracle(dataset):
    k, reads, fq, lst, d = dataset
    sizing = _sizing(cfg, k)
    bc = cfg.BatchConfig(reads_per_batch=256, max_read_len=96)
    _, specs, keys, counts, stats = driver.count_sharded(
        [fq], sizing, n_mesh=8, batch_cfg=bc, super_batch=2, device=DEV)
    oracle = oracle_count(reads, k, sizing.hb)
    assert dict(zip(keys.tolist(), counts.tolist())) == oracle
    assert stats["kmers"] == sum(oracle.values())
    assert stats["distinct"] == len(oracle) == sum(s.n_main for s in specs)


@pytest.mark.parametrize("n,rows", [(2, 256), (8, 1024)])
def test_count_sharded_sweeps_match_jax(tmp_path, capsys, n, rows):
    """Batches small enough for several merges at the host's cadence, and
    a trigger that fires mid-stream twice: the counted keys, counts and
    stats equal the JAX driver's."""
    rng = np.random.default_rng(5)
    k = 21
    reads = reads_from_genome(rng, random_genome(rng, 4000), 6000, 80,
                              error_rate=0.01)
    fq = str(tmp_path / "reads.fastq")
    write_fastq(fq, reads)
    bc = dict(reads_per_batch=rows, max_read_len=96)
    _, _, keys, counts, stats = driver.count_sharded(
        [fq], _sizing(cfg, k, 2, 5000), n_mesh=n,
        batch_cfg=cfg.BatchConfig(**bc), super_batch=2, device=DEV)
    assert capsys.readouterr().err.count("mid-stream") == 2
    _, _, jkeys, jcounts, jstats = jdriver.count_sharded(
        [fq], _sizing(jcfg, k, 2, 5000), n_mesh=n,
        batch_cfg=jcfg.BatchConfig(**bc), super_batch=2)
    np.testing.assert_array_equal(keys, jkeys)
    np.testing.assert_array_equal(counts, jcounts)
    assert {f: stats[f] for f in jstats} == jstats
    assert stats["sweeps"] == 2 and stats["merges"] > 2, stats


def test_dryrun_and_mesh_profiler_run_at_a_cpu_size():
    """The mesh layer's own entry points: the dry run on 8 shards and the
    routed-against-plain profiler at a CPU size (its times mean nothing
    here)."""
    from sh_assembly_tpu_torch.parallel import dryrun
    from sh_assembly_tpu_torch.profile import mesh

    got = dryrun.dryrun_multichip(8, DEV)
    assert got["step_kmers"] > 0 and got["scan_kmers"] > 0
    assert got["unitigs"] > 0
    assert mesh.main(["--device", DEV, "--n", "4", "--log2-capacity", "16",
                      "--rows-per-shard", "32", "--reps", "2"]) == 0
    assert mesh.LAST["keys"] == 4 * 4 * 32 * (160 - 31 + 1)
    assert mesh.LAST["ms"] > 0 and mesh.LAST["plain_ms"] > 0
