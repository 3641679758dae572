"""The benchmark's parts on their own: the generator, finding files by
name, the metric readers, the trace's reading, and what may be imported."""

from __future__ import annotations

import ast
import json
import os

import numpy as np
import pytest

from shbench import generate, kernels, registry, trace

HERE = registry.HERE
CFG = {"genome_length": 5000}
MIX = {"depth": 30, "read_length": 150, "both_strands": True,
       "sub_rate": 0.01}


def test_reads_depend_only_on_the_seed(tmp_path):
    a = generate.make_reads(2**31 + 5, CFG, MIX)
    b = generate.make_reads(2**31 + 5, CFG, MIX)
    c = generate.make_reads(2**31 + 6, CFG, MIX)
    assert a.shape == (1000, 150) and a.dtype == np.uint8
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    p1, p2 = tmp_path / "a.fq", tmp_path / "b.fq"
    generate.write_fastq(str(p1), a)
    generate.write_fastq(str(p2), b)
    assert p1.read_bytes() == p2.read_bytes()


def test_fastq_records_hold_the_reads(tmp_path):
    r = generate.make_reads(9, CFG, MIX)
    p = tmp_path / "r.fq"
    generate.write_fastq(str(p), r)
    lines = p.read_bytes().split(b"\n")
    assert lines[0] == b"@000" and lines[2] == b"+"
    assert lines[1] == b"ACGT"[0:0].join(
        bytes([b"ACGT"[x]]) for x in r[0])
    assert lines[3] == b"I" * 150 and len(lines) == 4 * 1000 + 1


def test_substitutions_at_the_stated_rate():
    mix = {**MIX, "sub_rate": 0.0}
    clean = generate.make_reads(3, {"genome_length": 200000}, mix)
    noisy = generate.make_reads(3, {"genome_length": 200000},
                                {**mix, "sub_rate": 0.01})
    assert abs(np.mean(clean != noisy) - 0.01) < 0.001


def test_every_named_part_is_found():
    bench = registry.load_benchmark()
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(registry.ROOT, c["file"]))
    for w in bench["workloads"]:
        cell = registry.resolve(w["name"])
        assert hasattr(cell["entry"], "Entry")
        for m in cell["end_to_end"] + cell["per_layer"]:
            assert callable(cell["readers"][m["name"]].read)


def test_added_files_are_picked_up_without_an_edit(tmp_path, bench_copy):
    root, here = bench_copy
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["per_layer"].append({
        "name": "jobs_done", "unit": "jobs", "better": "higher",
        "source": "program_counter", "layer": "harness",
        "moves": "assembly_s", "workloads": ["tiny.pipeline"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    with open(os.path.join(here, "metrics", "jobs_done.py"), "w") as f:
        f.write("def read(ctx):\n    return len(ctx['jobs'])\n")
    cell = registry.resolve("tiny.pipeline", root, here)
    assert cell["traffic"]["read_length"] == 150
    assert cell["config"]["genome_length"] == 30000
    assert [m["name"] for m in cell["per_layer"]][-1] == "jobs_done"
    assert cell["readers"]["jobs_done"].read({"jobs": [1, 2]}) == 2


def _ctx(**kw):
    phases = [{"count:host read/pack": 4.0, "count:device append": 0.5,
               "count:merge": 0.25, "count:finalize merge+sweeps": 0.25,
               "contiger:collect nodes": 3.0, "contiger:phantom closure": 0.1,
               "contiger:probe graph": 0.05, "contiger:contract": 9.0,
               "contiger:host assembly": 12.0, "contiger:fasta dump": 1.0,
               "simplify": 2.5}] * 2
    base = {"jobs": [{"batches": 100, "batch_rows": 8192, "row_len": 160}] * 2,
            "phases": phases, "window_s": 40.0, "setup_s": 20.0,
            "peak_bytes": 3 << 30, "trace": None, "kmers": 624_000_000,
            "config": {"k": 47}}
    base.update(kw)
    return base


@pytest.mark.parametrize("name,want", [
    ("setup_s", 20.0), ("assembly_s", 20.0), ("count_kmers_per_s", 15.6e6),
    ("peak_device_gib", 3.0), ("ingest_s.count", 4.0),
    ("counter_device_s.count", 1.0), ("count_s.pipeline", 5.0),
    ("collect_s", 3.0), ("probes_s", 0.15), ("contract_s", 9.0),
    ("host_assembly_s", 13.0), ("simplify_s", 2.5)])
def test_metric_readers_on_phase_stats(name, want):
    mod = registry.load_module(registry.metric_path(name), f"m_{name}")
    assert mod.read(_ctx()) == pytest.approx(want)


@pytest.mark.parametrize("name", [
    "ingest_s.count", "collect_s", "k5_roofline.count",
    "device_idle_pct.count", "device_idle_pct.pipeline"])
def test_metric_readers_with_nothing_to_read(name):
    mod = registry.load_module(registry.metric_path(name), f"m_{name}")
    assert mod.read(_ctx(phases=[{}, {}])) is None


def _events():
    """A synthetic trace: a job range of 10 ms, two phases, three kernels
    (two overlapping), a copy."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.JOB,
           "ts": 1000.0, "dur": 10000.0},
          {"ph": "X", "cat": "user_annotation", "name": "count:merge",
           "ts": 1000.0, "dur": 4000.0},
          {"ph": "X", "cat": "user_annotation", "name": "contiger:contract",
           "ts": 5000.0, "dur": 6000.0},
          {"ph": "X", "cat": "kernel",
           "name": "void (anonymous namespace)::k_hash_append(int)",
           "ts": 1500.0, "dur": 1000.0},
          {"ph": "X", "cat": "kernel", "name": "k_merge(Geo, long long*)",
           "ts": 2000.0, "dur": 1000.0},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
           "ts": 9000.0, "dur": 500.0},
          {"ph": "X", "cat": "cpu_op", "name": "aten::sort",
           "ts": 1200.0, "dur": 50.0}]
    return ev


def test_trace_summary_on_a_synthetic_trace():
    s = trace.summarize(_events())
    assert s.window_s == pytest.approx(0.010)
    assert s.busy_s == pytest.approx(0.002)  # 1.5-3.0 ms and 9.0-9.5 ms
    assert s.idle_pct == pytest.approx(80.0)
    assert s.op_seconds(kernels.K5_NAME) == pytest.approx(0.001)
    assert s.gaps[0] == ("contiger:contract", pytest.approx(0.006))
    assert s.gaps[1] == ("contiger:contract", pytest.approx(0.0015))
    assert s.gaps[2] == ("count:merge", pytest.approx(0.0005))
    b = trace.breakdown(s)
    assert len(b["device_ops"]) == 3 and len(b["idle_gaps"]) == 3


def test_k5_roofline_reads_the_trace():
    s = trace.summarize(_events())
    mod = registry.load_module(registry.metric_path("k5_roofline.count"),
                               "m_k5")
    jobs = [{"batches": 1, "batch_rows": 8192, "row_len": 160}]
    got = mod.read(_ctx(trace=s, jobs=jobs))
    want = 100.0 * kernels.k5_bytes(1, 8192, 160, 47) / 3.35e12 / 0.001
    assert got == pytest.approx(want)
    # PERF.md's count for profile.hot's stack of 8 x 8192 rows of 160
    assert kernels.k5_bytes(8, 8192, 160, 47) == 63_963_136


def _imports(path: str) -> set:
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _py_files(top: str):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_nothing_imports_jax_or_the_jax_package():
    for path in _py_files(HERE):
        bad = _imports(path) & {"jax", "jaxlib", "flax", "sh_assembly_tpu"}
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_program():
    for path in _py_files(os.path.join(HERE, "reference")):
        assert "sh_assembly_tpu_torch" not in _imports(path), path
        src = open(path).read()
        assert "sh_assembly_tpu_torch" not in src, path


def test_a_run_refuses_without_the_cell_s_devices(monkeypatch, capsys):
    import argparse

    import torch

    from shbench import runner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = argparse.Namespace(workload="ecoli.pipeline.30x", seed=1,
                              seconds=1.0, trace=0)
    assert runner.main(args, 0.0) != 0
    assert capsys.readouterr().out == ""


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import sys

    from shbench import runner

    monkeypatch.setitem(sys.modules, "sh_assembly_tpu_torch_x", object())
    assert runner.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "sh_assembly_tpu.ops", object())
    assert runner.forbidden_modules() == ["sh_assembly_tpu"]
