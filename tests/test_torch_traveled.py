"""The port's traveled queries (``query_set_traveled``,
``query_is_traveled``) on the CPU against the JAX package's, from one state
(``from_jax_planes``): counts, flags and the state after every batch,
bitwise.  Inputs are those of tests/test_spectrum.py's traveled tests plus
random batches with duplicate probes, absent keys, sentinel queries, the
maximum key and counts at the cap."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sh_assembly_tpu.ops import spectrum as jsp
from sh_assembly_tpu_torch.ops import bits
from sh_assembly_tpu_torch.ops import spectrum as sp

DEV = "cpu"  # the port's functions default to the GPU

SENT = np.uint64(0xFFFFFFFFFFFFFFFF)
KB = 40


def _jax_state(spec) -> dict:
    return dict(hi=np.asarray(spec.hi), lo=np.asarray(spec.lo),
                buf_hi=np.asarray(spec.buf_hi), buf_lo=np.asarray(spec.buf_lo),
                n_main=int(spec.n_main), n_buf=int(spec.n_buf),
                ndistinct=int(spec.ndistinct), nelts=int(spec.nelts))


def _port(jspec) -> sp.Spectrum:
    return sp.from_jax_planes(**_jax_state(jspec), device=DEV)


def _assert_same(port_spec, jspec):
    got, ref = sp.to_jax_planes(port_spec), _jax_state(jspec)
    for name in ("n_main", "n_buf", "ndistinct", "nelts"):
        assert got[name] == ref[name], name
    for name in ("hi", "lo", "buf_hi", "buf_lo"):
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)


def _set_both(js, ps, probes, key_bits):
    """One ``query_set_traveled`` batch through both packages, compared."""
    jc, jw, js = jsp.query_set_traveled(js, jnp.asarray(probes), key_bits)
    pc, pw, ps = sp.query_set_traveled(ps, bits.from_u64_np(probes, DEV),
                                       key_bits)
    assert pc.dtype == torch.int32 and pw.dtype == torch.bool
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(pw.numpy(), np.asarray(jw))
    _assert_same(ps, js)
    return js, ps, pc.numpy(), pw.numpy()


def _is_both(js, ps, probes, key_bits):
    jc, jw = jsp.query_is_traveled(js, jnp.asarray(probes), key_bits)
    pc, pw = sp.query_is_traveled(ps, bits.from_u64_np(probes, DEV),
                                  key_bits)
    assert pc.dtype == torch.int32 and pw.dtype == torch.bool
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(pw.numpy(), np.asarray(jw))
    _assert_same(ps, js)  # read-only
    return pw.numpy()


def _counted(keys, C=256, BC=128, key_bits=KB):
    js = jsp.make(C, BC)
    js = jsp.insert(js, jnp.asarray(np.asarray(keys, np.uint64)))
    js = jsp.merge(js, key_bits)
    return js, _port(js)


def test_traveled_semantics():
    js, ps = _counted([5, 6, 7])
    probes = np.array([5, 5, 99], np.uint64)
    # duplicate probes of one batch all see the state from before it
    js, ps, counts, was = _set_both(js, ps, probes, KB)
    assert counts.tolist() == [1, 1, 0] and was.tolist() == [False] * 3
    js, ps, _, was = _set_both(js, ps, probes, KB)
    assert was.tolist() == [True, True, False]
    assert _is_both(js, ps, np.array([6, 5], np.uint64), KB).tolist() == \
        [False, True]


def test_merge_preserves_traveled():
    js, ps = _counted([5, 6])
    js, ps, _, _ = _set_both(js, ps, np.array([5], np.uint64), KB)
    js = jsp.merge(jsp.insert(js, jnp.asarray(np.array([8], np.uint64))), KB)
    ps = sp.merge(sp.insert(ps, bits.from_u64_np(
        np.array([8], np.uint64), DEV)), KB)
    _assert_same(ps, js)
    keys, _, trav = sp.to_host(ps, KB)
    assert dict(zip(keys.tolist(), trav.tolist())) == {5: 1, 6: 0, 8: 0}


@pytest.mark.parametrize("key_bits,C", [(22, 1024), (33, 2048), (40, 4096),
                                        (56, 512)])
def test_random_batches(key_bits, C):
    rng = np.random.default_rng(key_bits)
    kmax = (1 << key_bits) - 1
    keys = np.unique(np.concatenate([
        rng.integers(0, 1 << key_bits, size=C // 3, dtype=np.uint64),
        np.array([0, kmax - 1, kmax], np.uint64)]))
    cap = jsp.count_cap(key_bits)
    counts = rng.integers(1, min(cap, 500), size=len(keys)).astype(np.int64)
    counts[::5] = cap
    trav = (rng.random(len(keys)) < 0.3).astype(np.uint8)
    js = jsp.from_host(keys, counts, C, 64, key_bits, traveled=trav)
    ps = _port(js)
    seen = trav.astype(bool)
    for _ in range(3):
        hit = rng.choice(len(keys), size=150)
        hit[:40] = hit[40:80]  # duplicates inside the batch
        probes = np.concatenate([
            keys[hit],
            rng.integers(0, 1 << key_bits, size=60, dtype=np.uint64),
            np.array([SENT, kmax, kmax, SENT, 0], np.uint64)])
        rng.shuffle(probes)
        js, ps, pc, pw = _set_both(js, ps, probes, key_bits)
        # against the dictionary: pre-batch flags, then every probed key set
        at = np.searchsorted(keys, probes)
        found = (probes != SENT) & (keys[np.minimum(at, len(keys) - 1)]
                                    == probes)
        idx = np.minimum(at, len(keys) - 1)
        np.testing.assert_array_equal(pw, found & seen[idx])
        np.testing.assert_array_equal(
            pc, np.where(found, np.minimum(counts, cap)[idx], 0))
        seen[idx[found]] = True
        flags = _is_both(js, ps, np.concatenate([keys, [SENT]]), key_bits)
        np.testing.assert_array_equal(flags[:-1], seen)
        assert not flags[-1]


def test_set_traveled_marks_the_store_in_place():
    _, ps = _counted([5, 6, 7])
    store = ps.store
    _, _, out = sp.query_set_traveled(
        ps, bits.from_u64_np(np.array([6], np.uint64), DEV), KB)
    assert out is ps and out.store is store
    _, _, trav = sp.to_host(ps, KB)
    assert trav.tolist() == [0, 1, 0]
