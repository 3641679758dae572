"""A whole run of each tiny cell on the CPU: the program's outputs against
the plain reference, and the result's shape."""

from __future__ import annotations

import pytest

from shbench import runner


@pytest.mark.parametrize("cell", ["tiny.pipeline", "tiny.count"])
def test_run_is_correct_on_cpu(bench_copy, cell):
    root, here = bench_copy
    res = runner.run(cell, 2**31 + 12345, 0, False, "cpu", root=root,
                     here=here)
    assert res["correct"], res["checks"]
    assert res["attempted"] == 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert all(c["value"] == 0 for c in res["checks"].values())
    assert "setup_s" in res["metrics"]
    want = "assembly_s" if cell == "tiny.pipeline" else "count_kmers_per_s"
    assert res["metrics"][want]["value"] > 0


def test_a_program_off_the_stated_sizing_is_refused(bench_copy):
    import json
    import os

    root, here = bench_copy
    path = os.path.join(here, "configs", "tiny-count.json")
    cfg = json.load(open(path))
    cfg["sizing"]["deNoise_trigger"] += 1
    json.dump(cfg, open(path, "w"))
    with pytest.raises(RuntimeError, match="sizing departs"):
        runner.run("tiny.count", 1, 0, False, "cpu", root=root, here=here)
