"""The port's store core (insert / merge / sweep, on the CPU through K1's
plain twin) against the JAX package's XLA merge path, bitwise.  Both start
from one state (``from_jax_planes``) and the whole resulting state is
compared in the JAX layout (``to_jax_planes``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sh_assembly_tpu.ops import spectrum as jsp
from sh_assembly_tpu_torch.ops import merge_cuda
from sh_assembly_tpu_torch.ops import spectrum as sp

DEV = "cpu"  # the port's functions default to the GPU

SENT = np.uint64(0xFFFFFFFFFFFFFFFF)


def _jax_state(spec) -> dict:
    return dict(hi=np.asarray(spec.hi), lo=np.asarray(spec.lo),
                buf_hi=np.asarray(spec.buf_hi), buf_lo=np.asarray(spec.buf_lo),
                n_main=int(spec.n_main), n_buf=int(spec.n_buf),
                ndistinct=int(spec.ndistinct), nelts=int(spec.nelts))


def _port(jspec) -> sp.Spectrum:
    return sp.from_jax_planes(**_jax_state(jspec), device=DEV)


def _assert_same(port_spec, jspec):
    got = sp.to_jax_planes(port_spec)
    ref = _jax_state(jspec)
    for name in ("n_main", "n_buf", "ndistinct", "nelts"):
        assert got[name] == ref[name], name
    for name in ("hi", "lo", "buf_hi", "buf_lo"):
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)


def _case_state(seed, key_bits, C_real, BC_real, hot):
    """The tests/test_merge_pallas.py inputs as a JAX spectrum: a merged
    main store plus a buffer of raw keys with sentinel holes."""
    rng = np.random.default_rng(seed)
    nk = rng.integers(1, max(2, C_real), endpoint=True) if C_real else 0
    mk = np.unique(rng.integers(0, 1 << key_bits, size=max(nk, 1),
                                dtype=np.uint64))[:C_real] \
        if C_real else np.empty(0, np.uint64)
    mc = rng.integers(1, 100, size=len(mk)).astype(np.int64)
    mt = rng.integers(0, 2, size=len(mk)).astype(np.uint8)
    n_buf = int(rng.integers(0, BC_real, endpoint=True)) if BC_real else 0
    pool = np.concatenate([mk, rng.integers(0, 1 << key_bits,
                                            size=max(8, n_buf),
                                            dtype=np.uint64)])
    bk = rng.choice(pool, size=n_buf) if n_buf else np.empty(0, np.uint64)
    if hot and n_buf > 10:
        bk[: n_buf // 2] = pool[0]
    holes = np.full(max(BC_real, 1), SENT, np.uint64)
    if n_buf:
        holes[rng.choice(len(holes), size=n_buf, replace=False)] = bk
    C = max(C_real, 1) + len(holes)
    spec = jsp.from_host(mk, mc, C, len(holes), key_bits, traveled=mt)
    return jsp.insert(spec, jnp.asarray(holes))


MERGE_CASES = [
    # (seed, key_bits, C_real, BC_real, drop, hot), as tests/test_merge_pallas
    (0, 33, 500, 1500, False, False),
    (1, 33, 500, 1500, True, False),
    (2, 24, 300, 2000, False, False),
    (3, 24, 300, 2000, True, True),
    (4, 40, 900, 3000, False, True),
    (5, 48, 10, 50, False, False),
    (6, 33, 0, 1000, False, False),
    (7, 33, 800, 0, True, False),
    (8, 20, 100, 700, False, False),
]


@pytest.mark.parametrize("seed,key_bits,C_real,BC_real,drop,hot",
                         MERGE_CASES)
def test_merge_matches_xla_path(seed, key_bits, C_real, BC_real, drop, hot):
    jspec = _case_state(seed, key_bits, C_real, BC_real, hot)
    launches = merge_cuda.LAUNCHES
    got = sp.merge(_port(jspec), key_bits, drop)
    assert merge_cuda.LAUNCHES == launches  # CPU tensors: the plain twin
    ref = jsp._merge_xla_path(jspec, key_bits, drop)
    _assert_same(got, ref)
    # and the deNoise sweep of the merged store
    _assert_same(sp.sweep(got, key_bits), jsp.sweep(ref, key_bits))


def _edge_state(key_bits, main_count):
    """Main store holding key 0, the maximum key and one middle key; a
    buffer hitting the maximum key hard plus singleton keys."""
    kmax = (1 << key_bits) - 1
    mk = np.array([0, 12345, kmax], np.uint64)
    mc = np.array([1, main_count, main_count], np.int64)
    mt = np.array([1, 0, 1], np.uint8)
    bk = np.concatenate([np.full(300, kmax, np.uint64),
                         np.array([7, 8, 9, 12345, 12345, 0], np.uint64),
                         np.full(40, SENT, np.uint64)])
    np.random.default_rng(key_bits).shuffle(bk)
    spec = jsp.from_host(mk, mc, 64, len(bk), key_bits, traveled=mt)
    return jsp.insert(spec, jnp.asarray(bk))


@pytest.mark.parametrize("key_bits,drop", [(33, False), (40, True),
                                           (56, False), (56, True)])
def test_max_key_and_cap_saturation(key_bits, drop):
    cap = sp.count_cap(key_bits)
    assert cap == jsp.count_cap(key_bits)
    jspec = _edge_state(key_bits, main_count=cap - 1)
    got = sp.merge(_port(jspec), key_bits, drop)
    ref = jsp._merge_xla_path(jspec, key_bits, drop)
    _assert_same(got, ref)
    keys, counts, trav = sp.to_host(got, key_bits)
    assert keys[-1] == (1 << key_bits) - 1 and counts[-1] == cap
    assert trav[-1] == 1


def test_insert_merge_sweep_sequence():
    """Several appends between merges, merges with and without the sweep:
    the full state matches after every step."""
    rng = np.random.default_rng(11)
    key_bits, C, BC = 30, 1 << 13, 1 << 12
    jspec = jsp.make(C, BC)
    spec = sp.from_jax_planes(**_jax_state(jspec), device=DEV)
    pool = rng.integers(0, 1 << key_bits, size=3000, dtype=np.uint64)
    for step in range(6):
        for _ in range(3):
            block = rng.choice(pool, size=1000)
            block[rng.random(1000) < 0.1] = SENT
            jspec = jsp.insert(jspec, jnp.asarray(block))
            spec = sp.insert(spec, torch.from_numpy(block.view(np.int64)))
            _assert_same(spec, jspec)
        drop = step % 2 == 1
        jspec = jsp._merge_xla_path(jspec, key_bits, drop)
        spec = sp.merge(spec, key_bits, drop)
        _assert_same(spec, jspec)
        if step == 3:
            jspec = jsp.sweep(jspec, key_bits)
            spec = sp.sweep(spec, key_bits)
            _assert_same(spec, jspec)


def test_host_roundtrip_and_overflow(rng):
    key_bits = 28
    keys = np.unique(rng.integers(0, 1 << key_bits, size=500,
                                  dtype=np.uint64))
    counts = rng.integers(1, 1000, size=len(keys))
    trav = rng.integers(0, 2, size=len(keys)).astype(np.uint8)
    spec = sp.from_host(keys, counts, 1024, 256, key_bits, traveled=trav,
                        device=DEV)
    jspec = jsp.from_host(keys, counts, 1024, 256, key_bits, traveled=trav)
    _assert_same(spec, jspec)
    k2, c2, t2 = sp.to_host(spec, key_bits)
    np.testing.assert_array_equal(k2, keys)
    np.testing.assert_array_equal(c2, counts)
    np.testing.assert_array_equal(t2, trav)
    # a merge into too small a store reports the true count and raises
    small = sp.from_host(keys, counts, len(keys), 256, key_bits,
                         device=DEV)
    fresh = np.arange(len(keys) + 1, len(keys) + 11, dtype=np.uint64)
    small = sp.insert(small, torch.from_numpy(fresh.view(np.int64)))
    merged = sp.merge(small, key_bits)
    assert merged.n_main == len(keys) + 10
    with pytest.raises(RuntimeError, match="overflow"):
        sp.check_overflow(merged)
