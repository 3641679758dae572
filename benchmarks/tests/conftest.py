"""Fixtures of the benchmark's CPU tests: a temporary copy of the
benchmark with two tiny cells (one a entry) added as new files.

Run: python -m pytest benchmarks/tests -q   (from the repo's root)
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
for p in (HERE, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_CONFIGS = {
    "tiny-pipeline": {"genome_length": 30000, "trueKmer": 300000,
                      "sizing": {"qb": 20, "key_bits": 28,
                                 "deNoise_rounds": 0,
                                 "deNoise_trigger": 365061}},
    "tiny-count": {"genome_length": 40000, "trueKmer": 400000,
                   "sizing": {"qb": 21, "key_bits": 29, "deNoise_rounds": 0,
                              "deNoise_trigger": 454217}},
}
TINY_TRAFFIC = {
    "tiny.30x": {"entry": "pipeline", "depth": 30, "reads": None,
                 "read_length": 150, "both_strands": True,
                 "sub_rate": 0.00234},
    "tiny.5k": {"entry": "count", "depth": None, "reads": 5000,
                "read_length": 150, "both_strands": True,
                "sub_rate": 0.00234},
}
# (cell, config, traffic, the real cell whose metrics it reports)
TINY_CELLS = [("tiny.pipeline", "tiny-pipeline", "tiny.30x",
               "ecoli.pipeline.30x"),
              ("tiny.count", "tiny-count", "tiny.5k", "celegans.count")]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.fixture
def bench_copy(tmp_path):
    """(root, here) of a copy of the benchmark with the tiny cells."""
    root = tmp_path / "checkout"
    here = root / "benchmarks"
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns(
        "tests", "_cache", "__pycache__"))
    bench = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    base = json.loads(open(os.path.join(
        HERE, "configs", "ecoli-k12-mg1655.json")).read())
    for name, over in TINY_CONFIGS.items():
        cfg = {**base, **over, "name": name}
        (here / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "test",
                                 "file": f"benchmarks/configs/{name}.json",
                                 "reduced": [], "why": "test"})
    for name, t in TINY_TRAFFIC.items():
        (here / "traffic" / f"{name}.json").write_text(json.dumps(t))
    for cell, cfg, traffic, like in TINY_CELLS:
        bench["workloads"].append({"name": cell, "config": cfg,
                                   "traffic": traffic, "chips": 1,
                                   "why": "test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(root), str(here)
