"""The port's spectrum queries (``query``, ``query_join``,
``query_join_sorted`` and ``query_join_auto``; on the CPU the last two run
K2's plain version) against the JAX package's ``query_join``, bitwise, and
K2's plain version against the TPU kernel ``count_join_planes`` run in
Pallas interpret mode."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sh_assembly_tpu.ops import spectrum as jsp
from sh_assembly_tpu_torch.ops import bits, join_cuda
from sh_assembly_tpu_torch.ops import spectrum as sp

# the interpret-mode harness of the JAX package's own kernel test
from test_join_pallas import run_kernel

SENT = np.uint64(0xFFFFFFFFFFFFFFFF)


def _spectra(keys, counts, trav, key_bits, capacity=None):
    C = capacity or 1 << int(np.ceil(np.log2(len(keys) + 1)))
    js = jsp.from_host(keys, counts, C, 1 << 10, key_bits, traveled=trav)
    ps = sp.from_host(keys, counts, C, 1 << 10, key_bits, traveled=trav)
    return js, ps


def _case(seed, key_bits, n_spec, n_q, n_sent=37):
    """A spectrum with traveled entries, counts at the cap and the maximum
    key, and unsorted queries: present keys, random keys, the maximum key,
    sentinels."""
    rng = np.random.default_rng(seed)
    kmax = (1 << key_bits) - 1
    keys = np.unique(np.concatenate([
        rng.integers(0, 1 << key_bits, size=n_spec, dtype=np.uint64),
        np.array([0, kmax], np.uint64)]))
    counts = rng.integers(1, 200, size=len(keys))
    counts[::7] = sp.count_cap(key_bits)
    trav = (rng.random(len(keys)) < 0.4).astype(np.uint8)
    q = np.concatenate([
        rng.choice(keys, size=n_q // 2),
        rng.integers(0, 1 << key_bits, size=n_q - n_q // 2, dtype=np.uint64),
        np.array([kmax, kmax, 0], np.uint64), np.full(n_sent, SENT)])
    return keys, counts, trav, q[rng.permutation(len(q))]


@pytest.mark.parametrize("seed,key_bits,n_spec,n_q", [
    (0, 22, 700, 900), (1, 22, 2000, 300), (2, 36, 1500, 1500),
    (3, 37, 5000, 4000), (4, 56, 300, 80)])
def test_queries_match_jax_query_join(seed, key_bits, n_spec, n_q):
    keys, counts, trav, q = _case(seed, key_bits, n_spec, n_q)
    js, ps = _spectra(keys, counts, trav, key_bits)
    ref = np.asarray(jsp.query_join(js, jnp.asarray(q), key_bits))
    assert (ref > 0).sum() > n_q // 3
    tq = bits.from_u64_np(q)
    for fn in (sp.query, sp.query_join, sp.query_join_auto):
        got = fn(ps, tq, key_bits)
        assert got.dtype == torch.int32, fn.__name__
        np.testing.assert_array_equal(got.numpy(), ref, fn.__name__)
    order = np.argsort(q, kind="stable")
    got = sp.query_join_sorted(ps, bits.from_u64_np(q[order]), key_bits)
    np.testing.assert_array_equal(got.numpy(), ref[order])


def test_queries_against_an_empty_spectrum():
    key_bits = 30
    js, ps = _spectra(np.zeros(0, np.uint64), np.zeros(0, np.int64), None,
                      key_bits, capacity=1024)
    rng = np.random.default_rng(5)
    q = np.concatenate([rng.integers(0, 1 << key_bits, size=500,
                                     dtype=np.uint64),
                        np.array([(1 << key_bits) - 1, SENT], np.uint64)])
    ref = np.asarray(jsp.query_join(js, jnp.asarray(q), key_bits))
    assert not ref.any()
    for fn in (sp.query, sp.query_join, sp.query_join_auto):
        assert not fn(ps, bits.from_u64_np(q), key_bits).any()


def test_query_join_budget_checks_match_jax():
    # the query-index field: fewer than 2^(payload_bits - 1) queries
    key_bits = 56
    js, ps = _spectra(np.arange(5, dtype=np.uint64), np.ones(5, np.int64),
                      None, key_bits)
    q = np.zeros(1 << 7, np.uint64)
    with pytest.raises(ValueError, match="too large"):
        jsp.query_join(js, jnp.asarray(q), key_bits)
    with pytest.raises(ValueError, match="too large"):
        sp.query_join(ps, bits.from_u64_np(q), key_bits)
    # the run-id field: (C + Nq).bit_length() + payload_bits - 1 <= 63
    key_bits = 22
    js, ps = _spectra(np.arange(5, dtype=np.uint64), np.ones(5, np.int64),
                      None, key_bits, capacity=1 << 21)
    q = np.zeros(1 << 21, np.uint64)
    with pytest.raises(ValueError, match="run-id"):
        jsp.query_join(js, jnp.asarray(q), key_bits)
    with pytest.raises(ValueError, match="run-id"):
        sp.query_join(ps, bits.from_u64_np(q), key_bits)


def test_plain_count_join_matches_interpreted_tpu_kernel():
    """One case at tests/test_join_pallas.py's kernel geometry."""
    keys, counts, trav, q = _case(6, 22, 1500, 1200)
    js, ps = _spectra(keys, counts, trav, 22)
    q = np.sort(q)  # ascending, sentinels last
    got = join_cuda.count_join(ps.store, ps.n_main, bits.from_u64_np(q), 22)
    ref = run_kernel(js, q, 22)
    live = q != SENT
    np.testing.assert_array_equal(got.numpy()[live], ref[live])
    assert not got.numpy()[~live].any()
