"""Finding a cell's parts by name.

``BENCHMARK.json`` names cells, configurations and metrics; each of those
is a file of its own under ``benchmarks/``, found by its name:

  configs/<config>.json       the configuration (the ``file`` of its entry)
  traffic/<traffic>.json      a traffic mix: parameters only
  entries/<entry>.py          the program call a mix's jobs make
  metrics/<metric>.py         a metric's reader: ``read(ctx)``

Adding a cell, a mix or a metric adds files and ``BENCHMARK.json``
entries; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _by_name(items: list, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traffic_path(name: str, here: str = HERE) -> str:
    return os.path.join(here, "traffic", f"{name}.json")


def entry_path(name: str, here: str = HERE) -> str:
    return os.path.join(here, "entries", f"{name}.py")


def metric_path(name: str, here: str = HERE) -> str:
    return os.path.join(here, "metrics", f"{name}.py")


def cell_metrics(bench: dict, cell: str) -> tuple[list, list]:
    """(end-to-end metrics, per-layer metrics) that the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def resolve(workload: str, root: str = ROOT, here: str = HERE) -> dict:
    """Everything a run of one cell needs, found by name."""
    bench = load_benchmark(root)
    cell = _by_name(bench["workloads"], workload, "workload")
    conf_entry = _by_name(bench["configs"], cell["config"], "config")
    config = load_json(os.path.join(root, conf_entry["file"]))
    traffic = load_json(traffic_path(cell["traffic"], here))
    e2e, layer = cell_metrics(bench, workload)
    return {
        "bench": bench, "cell": cell, "config": config, "traffic": traffic,
        "entry": load_module(entry_path(traffic["entry"], here),
                             f"shbench_entry_{traffic['entry']}"),
        "end_to_end": e2e, "per_layer": layer,
        "readers": {m["name"]: load_module(metric_path(m["name"], here),
                                           f"shbench_metric_{m['name']}")
                    for m in e2e + layer},
    }
