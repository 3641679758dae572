"""The tiny cells on the card: a whole run judged correct, and the control
judged not correct.  Skips without a CUDA device; run on the card with
``python -m pytest benchmarks/tests/test_benchmarks_cuda.py``."""

from __future__ import annotations

import pytest

import readings
from shbench import runner

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("cell", ["tiny.pipeline", "tiny.count"])
def test_run_is_correct_on_the_card(bench_copy, cuda_device, cell):
    root, here = bench_copy
    res = runner.run(cell, 31337, 0, True, cuda_device, root=root,
                     here=here)
    assert res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0
    assert res["breakdown"]["device_ops"]


@pytest.mark.parametrize("cell", ["tiny.pipeline", "tiny.count"])
def test_control_fails_on_the_card(bench_copy, cuda_device, cell):
    root, here = bench_copy
    r = readings.readings(cell, 5, cuda_device, True, root=root, here=here)
    assert all(v == 0 for v in r["program"].values()), r["program"]
    assert r["control"]["spectrum_keys_apart"] > 0
