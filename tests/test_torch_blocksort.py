"""Kernel K4's plain version (``ops.blocksort_cuda.block_sort_plain``, which
``block_sort`` takes for CPU tensors) against the TPU kernel itself in
interpret mode and against ``np.sort`` per window, bitwise, and the
wrapper's refusals.

``profile_blocksort.py`` sorts 2^27 values when it is imported, so the test
parses its source, keeps the imports, ``LANES`` and the function
definitions, and executes only those."""

import ast
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from sh_assembly_tpu_torch.ops import bits
from sh_assembly_tpu_torch.ops import blocksort_cuda as bs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tpu_block_sort():
    """``block_sort`` of profile_blocksort.py without the script's run."""
    path = os.path.join(REPO, "profile_blocksort.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    keep = [n for n in tree.body
            if isinstance(n, (ast.Import, ast.ImportFrom, ast.FunctionDef))
            or (isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", "") == "LANES")]
    ns = {}
    exec(compile(ast.Module(keep, []), path, "exec"), ns)
    return ns["block_sort"]


def _values(seed, n):
    """u32 values over the whole range, the extremes included."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    x[rng.integers(0, n, size=n // 16)] = 0xFFFFFFFF
    x[rng.integers(0, n, size=n // 16)] = 0
    x[rng.integers(0, n, size=n // 16)] = 0x80000000
    return x


def _port_sort(x, W):
    out = bs.block_sort(torch.from_numpy(x.view(np.int32)), W)
    assert out.dtype == torch.int32 and out.shape == (len(x),)
    return out.numpy().view(np.uint32)


def _np_sort(x, W):
    return np.sort(x.reshape(-1, W), axis=1).reshape(-1)


@pytest.mark.parametrize("log2_w,g", [(10, 4), (15, 2), (16, 2)])
def test_plain_matches_tpu_kernel_interpreted(log2_w, g):
    """Windows that share a block of the CUDA kernel, fill one, and fill a
    cluster of two."""
    W, N = 1 << log2_w, g << log2_w
    x = _values(0, N)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(_tpu_block_sort()(jnp.asarray(x), W))
    assert ref.dtype == np.uint32
    np.testing.assert_array_equal(ref, _np_sort(x, W))
    np.testing.assert_array_equal(_port_sort(x, W), ref)


@pytest.mark.parametrize("log2_w,g", [(7, 5), (10, 3), (13, 4), (15, 2),
                                      (16, 3), (17, 2), (18, 3), (19, 1)])
def test_plain_matches_np_sort_per_window(log2_w, g):
    W = 1 << log2_w
    x = _values(log2_w, g * W)
    assert (x >> 31).any()  # a signed compare would order these first
    np.testing.assert_array_equal(_port_sort(x, W), _np_sort(x, W))


@pytest.mark.parametrize("fill", ["equal", "sorted", "reversed", "extremes"])
def test_plain_on_degenerate_windows(fill):
    W, g = 256, 3
    x = {"equal": np.full(g * W, 0xDEADBEEF, np.uint32),
         "sorted": np.sort(_values(1, g * W)),
         "reversed": np.sort(_values(2, g * W))[::-1].copy(),
         "extremes": np.where(_values(3, g * W) & 1, 0xFFFFFFFF,
                              0).astype(np.uint32)}[fill]
    np.testing.assert_array_equal(_port_sort(x, W), _np_sort(x, W))


def test_flip32_orders_unsigned():
    x = _values(4, 512)
    t = bits.flip32(torch.from_numpy(x.view(np.int32)))
    order = torch.sort(t, stable=True).indices.numpy()
    np.testing.assert_array_equal(order, np.argsort(x, kind="stable"))
    assert torch.equal(bits.flip32(t), torch.from_numpy(x.view(np.int32)))


@pytest.mark.parametrize("fn", [bs.block_sort, bs.block_sort_plain,
                                bs.block_sort_cuda])
@pytest.mark.parametrize("bad", ["w_not_pow2", "w_below_lanes", "ragged",
                                 "dtype", "strided", "two_d"])
def test_refusals(fn, bad):
    x = torch.zeros(1024, dtype=torch.int32)
    x, W = {"w_not_pow2": (x[:768], 384), "w_below_lanes": (x, 64),
            "ragged": (x[:640], 256), "dtype": (x.long(), 128),
            "strided": (x[::2], 128), "two_d": (x.view(2, 512), 128)}[bad]
    with pytest.raises(ValueError):
        fn(x, W)


def test_cuda_wrapper_refuses_cpu_tensor():
    before = bs.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        bs.block_sort_cuda(torch.zeros(256, dtype=torch.int32), 128)
    assert bs.LAUNCHES == before


def test_smoke_cases_cover_every_path_of_the_cuda_kernel():
    """chip_smoke.k4_cases, which the card runs: windows below, at and
    above a block's 2^15 words and a cluster's 2^17, and more windows of
    2^17 than the 33 clusters an H100 holds at once; on the CPU the
    wrapper's plain version sorts them as numpy does."""
    import chip_smoke

    seen = {}
    for name, x, W in chip_smoke.k4_cases("cpu"):
        seen.setdefault(W, set()).add(x.numel() // W)
        if name.endswith("_random") and x.numel() <= 1 << 20:
            v = x.numpy().view(np.uint32)
            np.testing.assert_array_equal(
                bs.block_sort(x, W).numpy().view(np.uint32), _np_sort(v, W))
    assert {1 << 7, 1 << 15, 1 << 16, 1 << 17, 1 << 18, 1 << 19} <= set(seen)
    assert max(seen[1 << 17]) > 33
    assert all(x.numel() % W == 0 for _, x, W in chip_smoke.k4_cases("cpu"))
