"""The deNoise cell's parts: its configuration, traffic, entry and metrics
found by name without an edit; the two readers on phase stats and on
nothing; a whole tiny cell on the CPU whose rounds fire in mid-stream,
judged against ``reference/denoise.py``; the controls reading apart; and
the entry's refusals (a stated geometry the program does not run, a
program that counts no rounds)."""

from __future__ import annotations

import json
import os

import pytest

import readings_denoise
from shbench import registry, runner

CELL = "ecoli.pipeline.100x"
# a 20 kbp genome at 100x: 13,333 reads, qb 16, 10 rounds stated, 6 fire
TINY_CONFIG = {"genome_length": 20000,
               "sizing": {"qb": 16, "key_bits": 24, "deNoise_rounds": 10,
                          "deNoise_trigger": 33143},
               "geometry": {"batch_rows": 128, "row_len": 160,
                            "buffer_slots": 1 << 20}}
TINY_TRAFFIC = {"entry": "pipeline_denoise", "depth": 100, "reads": None,
                "read_length": 150, "both_strands": True,
                "sub_rate": 0.00234}


@pytest.fixture
def denoise_copy(bench_copy):
    """The benchmark's copy with a tiny deNoise cell, ``tiny.denoise``."""
    root, here = bench_copy
    base = json.load(open(os.path.join(here, "configs",
                                       "ecoli-k12-mg1655-100x.json")))
    cfg = {**base, **TINY_CONFIG, "name": "tiny-denoise"}
    with open(os.path.join(here, "configs", "tiny-denoise.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(here, "traffic", "tiny.100x.json"), "w") as f:
        json.dump(TINY_TRAFFIC, f)
    path = os.path.join(root, "BENCHMARK.json")
    bench = json.load(open(path))
    bench["configs"].append({"name": "tiny-denoise", "source": "test",
                             "file": "benchmarks/configs/tiny-denoise.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny.denoise",
                               "config": "tiny-denoise",
                               "traffic": "tiny.100x", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append("tiny.denoise")
    json.dump(bench, open(path, "w"))
    return root, here


def test_the_cell_s_parts_are_found_without_an_edit():
    cell = registry.resolve(CELL)
    assert cell["config"]["sizing"] == {
        "qb": 24, "key_bits": 32, "deNoise_rounds": 7,
        "deNoise_trigger": 8835924}
    assert cell["traffic"]["entry"] == "pipeline_denoise"
    assert set(cell["entry"].LIMITS) == {
        "spectrum_keys_apart", "spectrum_counts_apart", "unitigs_apart",
        "links_apart", "contigs_apart", "rounds_apart", "swept_apart"}
    assert not any(cell["entry"].LIMITS.values())
    assert [m["name"] for m in cell["end_to_end"]] == [
        "assembly_s", "peak_device_gib", "setup_s"]
    assert [m["name"] for m in cell["per_layer"]] == [
        "denoise_sweep_s", "early_merge_s"]
    for m in cell["end_to_end"] + cell["per_layer"]:
        assert callable(cell["readers"][m["name"]].read)


def test_the_stated_sizing_and_geometry_are_the_program_s():
    from sh_assembly_tpu_torch import config as cfg
    from sh_assembly_tpu_torch.models import counter
    from shbench import cellflags, generate

    c = registry.resolve(CELL)
    config, traffic = c["config"], c["traffic"]
    n = generate.n_reads(config, traffic)
    assert n == 3_094_435
    sizing = cfg.size_counter(47, config["genome_length"],
                              n * cellflags.windows(config, traffic),
                              alpha=0.00234, end_deNoise=True)
    cellflags.refuse_other_sizing(config, sizing)
    shape = cellflags.batch_shape(counter, sizing)
    geo = config["geometry"]
    assert shape == {"batch_rows": geo["batch_rows"],
                     "row_len": geo["row_len"]}
    assert geo["buffer_slots"] == 1 << 23 == sizing.nslots // 2


@pytest.mark.parametrize("name,want", [
    ("denoise_sweep_s", 0.125), ("early_merge_s", 0.5)])
def test_readers_on_phase_stats(name, want):
    mod = registry.load_module(registry.metric_path(name), f"m_{name}")
    ctx = {"phases": [{"count:merge": 2.0, "count:merge.early": 0.75,
                       "count:merge.deNoise": 0.125,
                       "count:finalize merge+sweeps.deNoise": 0.0625},
                      {"count:merge": 1.0, "count:merge.early": 0.25,
                       "count:merge.deNoise": 0.0625}]}
    assert mod.read(ctx) == pytest.approx(want)


@pytest.mark.parametrize("name", ["denoise_sweep_s", "early_merge_s"])
def test_readers_with_nothing_to_read(name):
    mod = registry.load_module(registry.metric_path(name), f"m_{name}")
    assert mod.read({"phases": [{"count:merge": 1.0}, {}]}) is None


def test_tiny_cell_is_correct_on_cpu(denoise_copy):
    root, here = denoise_copy
    res = runner.run("tiny.denoise", 2**31 + 777, 0, True, "cpu",
                     root=root, here=here)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == {
        "spectrum_keys_apart", "spectrum_counts_apart", "unitigs_apart",
        "links_apart", "contigs_apart", "rounds_apart", "swept_apart"}
    assert all(c["value"] == 0 for c in res["checks"].values())
    for m in ("denoise_sweep_s", "early_merge_s"):
        assert res["metrics"][m]["value"] > 0


def test_tiny_cell_s_controls_read_apart(denoise_copy):
    root, here = denoise_copy
    r = readings_denoise.readings("tiny.denoise", 2**31 + 778, "cpu",
                                  root=root, here=here)
    assert all(v == 0 for v in r["program"].values()), r["program"]
    assert r["job"]["rounds"] > 1 and r["job"]["early_merges"] > 0
    assert r["control"]["spectrum_keys_apart"] > 0
    assert r["control"]["unitigs_apart"] > 0
    assert r["cadence_control"]["spectrum_keys_apart"] > 0
    assert r["cadence_control"]["swept_apart"] > 0


def test_a_geometry_the_program_does_not_run_is_refused(denoise_copy):
    root, here = denoise_copy
    path = os.path.join(here, "configs", "tiny-denoise.json")
    cfg = json.load(open(path))
    cfg["geometry"]["buffer_slots"] //= 2
    json.dump(cfg, open(path, "w"))
    with pytest.raises(RuntimeError, match="geometry departs"):
        runner.run("tiny.denoise", 1, 0, False, "cpu", root=root, here=here)


def test_a_program_without_the_round_counters_is_refused(monkeypatch):
    from dataclasses import dataclass

    from sh_assembly_tpu_torch.models import counter

    @dataclass
    class Older:
        batches: int = 0
        sweeps: int = 0

    monkeypatch.setattr(counter, "BuildStats", Older)
    entry = registry.resolve(CELL)["entry"]
    with pytest.raises(RuntimeError, match="counts no"):
        entry.Entry({"config": {}, "traffic": {}, "n_reads": 0})
