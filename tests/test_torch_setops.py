"""The port's set operations (``union``, ``inner_product``, ``intersect``,
``magnitude``) on the CPU against the JAX package's, from one state
(``from_jax_planes``): the resulting planes and counters bitwise
(``to_jax_planes``), ``magnitude`` to 1e-12 relative (float64 sums taken in
another order).  Inputs are the shapes of tests/test_setops.py plus counts
at the cap, traveled entries on both sides, the maximum key and a union
that overflows a's capacity."""

import numpy as np
import pytest

from sh_assembly_tpu.ops import spectrum as jsp
from sh_assembly_tpu_torch.ops import join_cuda
from sh_assembly_tpu_torch.ops import spectrum as sp

DEV = "cpu"  # the port's functions default to the GPU


def _jax_state(spec) -> dict:
    return dict(hi=np.asarray(spec.hi), lo=np.asarray(spec.lo),
                buf_hi=np.asarray(spec.buf_hi), buf_lo=np.asarray(spec.buf_lo),
                n_main=int(spec.n_main), n_buf=int(spec.n_buf),
                ndistinct=int(spec.ndistinct), nelts=int(spec.nelts))


def _assert_same(port_spec, jspec):
    got, ref = sp.to_jax_planes(port_spec), _jax_state(jspec)
    for name in ("n_main", "n_buf", "ndistinct", "nelts"):
        assert got[name] == ref[name], name
    for name in ("hi", "lo", "buf_hi", "buf_lo"):
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)


def _side(rng, key_bits, n, lo, hi, capacity, big_counts):
    """One merged spectrum in both packages: distinct keys in [lo, hi),
    the maximum key among them, counts up to and past the cap, ~40 %
    traveled."""
    keys = np.unique(np.concatenate([
        rng.integers(lo, hi, size=n, dtype=np.uint64),
        np.array([(1 << key_bits) - 1], np.uint64)]))
    cap = jsp.count_cap(key_bits)
    counts = rng.integers(1, 200, size=len(keys)).astype(np.int64)
    if big_counts:
        counts[::3] = cap - rng.integers(0, 3, size=len(counts[::3]))
        counts[1::7] = cap + 5  # from_host saturates these
    trav = (rng.random(len(keys)) < 0.4).astype(np.uint8)
    js = jsp.from_host(keys, counts, capacity, 64, key_bits, traveled=trav)
    return js, sp.from_jax_planes(**_jax_state(js), device=DEV)


# (key_bits, n_a, range_a, n_b, range_b, C_a, C_b, counts at the cap)
CASES = {
    "setops_union": (40, 400, (0, 300), 350, (0, 300), 2048, 2048, False),
    "setops_inner": (40, 300, (0, 100), 300, (50, 150), 2048, 2048, False),
    "setops_intersect": (40, 300, (0, 120), 300, (60, 200), 2048, 1024,
                         False),
    "cap_kb40": (40, 500, (0, 700), 500, (300, 1000), 2048, 2048, True),
    # 7 count bits: the cap is 126, and query_join takes < 128 probes
    "cap_kb56": (56, 60, (0, 90), 50, (30, 120), 100, 120, True),
    "wide_kb33": (33, 800, (0, 1 << 33), 900, (0, 1 << 33), 4096, 1024, True),
    "disjoint": (36, 200, (0, 1000), 200, (5000, 9000), 512, 512, False),
    # more distinct keys than a holds: n_main reports all of them
    "union_overflow": (40, 300, (0, 5000), 300, (5000, 9000), 400, 512,
                       False),
}


@pytest.fixture(params=list(CASES), scope="module")
def pair(request):
    kb, na, ra, nb, rb, Ca, Cb, big = CASES[request.param]
    rng = np.random.default_rng(sorted(CASES).index(request.param))
    return kb, _side(rng, kb, na, *ra, Ca, big), _side(rng, kb, nb, *rb, Cb,
                                                      big)


def test_union(pair):
    kb, (ja, pa), (jb, pb) = pair
    ref = jsp.union(ja, jb, kb)
    got = sp.union(pa, pb, kb)
    _assert_same(got, ref)
    assert got.capacity == pa.capacity and got.buf_capacity == pa.buf_capacity
    if got.n_main > got.capacity:
        with pytest.raises(RuntimeError, match="overflow"):
            sp.check_overflow(got)


def test_intersect(pair):
    kb, (ja, pa), (jb, pb) = pair
    _assert_same(sp.intersect(pa, pb, kb), jsp.intersect(ja, jb, kb))
    _assert_same(sp.intersect(pb, pa, kb), jsp.intersect(jb, ja, kb))


def test_inner_product(pair):
    kb, (ja, pa), (jb, pb) = pair
    ref = int(jsp.inner_product(ja, jb, kb))
    got = sp.inner_product(pa, pb, kb)
    assert got.dtype.is_floating_point is False and int(got) == ref
    assert int(sp.inner_product(pb, pa, kb)) == ref


def test_magnitude(pair):
    kb, (ja, pa), (jb, pb) = pair
    for j, p in ((ja, pa), (jb, pb)):
        ref = float(jsp.magnitude(j, kb))
        got = sp.magnitude(p, kb)
        assert str(got.dtype) == "torch.float64"
        assert abs(float(got) - ref) <= 1e-12 * ref


def test_set_operations_leave_their_inputs(pair):
    kb, (ja, pa), (jb, pb) = pair
    sp.union(pa, pb, kb)
    sp.intersect(pa, pb, kb)
    sp.inner_product(pa, pb, kb)
    _assert_same(pa, ja)
    _assert_same(pb, jb)


def test_probes_go_through_the_sorted_join(monkeypatch):
    """inner_product and intersect probe b with a's ascending keys through
    ``count_join`` (kernel K2 on CUDA tensors), with no sort before it."""
    kb, _, _, _, _, Ca, Cb, _ = CASES["setops_intersect"]
    rng = np.random.default_rng(9)
    _, pa = _side(rng, kb, 300, 0, 120, Ca, False)
    _, pb = _side(rng, kb, 300, 60, 200, Cb, False)
    calls = []
    real = join_cuda.count_join

    def spy(store, n_main, queries, key_bits):
        calls.append(queries.clone())
        return real(store, n_main, queries, key_bits)

    monkeypatch.setattr(join_cuda, "count_join", spy)
    sp.inner_product(pa, pb, kb)
    sp.intersect(pa, pb, kb)
    assert len(calls) == 2
    for q in calls:
        live = q[q != -1]
        assert q.numel() == Ca and (live[1:] > live[:-1]).all()
        assert (q[live.numel():] == -1).all()
