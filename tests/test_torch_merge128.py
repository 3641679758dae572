"""The Contiger's node-store fold: K3's plain version (and the port's whole
flush, which K3 and K2 serve) against the JAX package's XLA fold,
bitwise, at k = 47 and k = 63 and with an overflowing store, and K3's plain
version against the TPU kernel ``merge128_planes`` run in Pallas
interpret mode."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sh_assembly_tpu.models import contiger as jcontiger
from sh_assembly_tpu.ops import merge128_pallas as m128
from sh_assembly_tpu.ops import spectrum as jsp
from sh_assembly_tpu_torch.models import contiger
from sh_assembly_tpu_torch.ops import bits, kmerpack as kp, merge128_cuda
from sh_assembly_tpu_torch.ops import spectrum as sp

# the inputs and interpret-mode harness of the JAX package's kernel test
from test_merge128_pallas import L, A, _maybe_interpret, _mk_stream, \
    _rand_kmers

DEV = "cpu"  # the port's functions default to the GPU

SENT = np.uint64(0xFFFFFFFFFFFFFFFF)


def _rand_pairs(rng, n: int, k: int):
    """n distinct left-aligned packed k-mers as sorted uint64 (hi, lo)."""
    hi = rng.integers(0, 1 << 64, size=n, dtype=np.uint64)
    lo = rng.integers(0, 1 << 64, size=n, dtype=np.uint64)
    if 2 * k <= 64:
        hi &= ~np.uint64((1 << (64 - 2 * k)) - 1)
        lo[:] = 0
    else:
        lo &= ~np.uint64((1 << (128 - 2 * k)) - 1)
    pairs = np.unique(np.stack([hi, lo], 1), axis=0)
    return pairs[:, 0].copy(), pairs[:, 1].copy()


def _t(a) -> torch.Tensor:
    return bits.from_u64_np(np.asarray(a, np.uint64), DEV)


@pytest.mark.parametrize("k,abundance_min,overflow", [
    (47, 0, False), (47, 2, False), (47, 2, True),
    (63, 0, False), (63, 2, True)])
def test_flush_matches_jax_xla_fold(k, abundance_min, overflow):
    rng = np.random.default_rng(k * 10 + abundance_min + overflow)
    key_bits = 24
    hi, lo = _rand_pairs(rng, 6000, k)
    n = len(hi)
    na = 2000
    node_cap = 2500 if overflow else 8192
    # the store: na distinct sorted k-mers, some seeds, a sentinel tail
    s_hi = np.full(node_cap, SENT)
    s_lo = np.full(node_cap, SENT)
    s_seed = np.zeros(node_cap, np.uint8)
    s_hi[:na], s_lo[:na] = hi[:na], lo[:na]
    s_seed[:na] = rng.random(na) < 0.3
    # the pending buffer: windows of stored and new k-mers, each k-mer
    # staged several times with mixed seed flags, invalid lanes between
    P, n_live_p = 8192, 7000
    pick = np.concatenate([rng.integers(0, na, 2000),
                           rng.integers(na, n, n_live_p - 2000)])
    p_hi = np.full(P, SENT)
    p_lo = np.full(P, SENT)
    p_key = np.full(P, SENT)
    p_seed = np.zeros(P, np.uint8)
    p_hi[:n_live_p], p_lo[:n_live_p] = hi[pick], lo[pick]
    kmer_key = rng.integers(0, 1 << key_bits, size=n, dtype=np.uint64)
    p_key[:n_live_p] = kmer_key[pick]
    p_seed[:n_live_p] = rng.random(n_live_p) < 0.2
    bad = rng.random(n_live_p) < 0.1
    for a in (p_hi, p_lo, p_key):
        a[:n_live_p][bad] = SENT
    p_seed[:n_live_p][bad] = 0
    # the spectrum: every key counted, a third of them once
    keys = np.unique(kmer_key)
    counts = np.where(rng.random(len(keys)) < 0.33, 1,
                      rng.integers(2, 50, len(keys)))
    C = 1 << int(np.ceil(np.log2(len(keys) + 1)))
    jspec = jsp.from_host(keys, counts, C, 1 << 10, key_bits)
    spec = sp.from_host(keys, counts, C, 1 << 10, key_bits, device=DEV)

    oh, ol, oseed, n_store, *_ = jcontiger._flush_pending(
        jspec, jnp.asarray(s_hi), jnp.asarray(s_lo), jnp.asarray(s_seed),
        jnp.asarray(p_hi), jnp.asarray(p_lo), jnp.asarray(p_key),
        jnp.asarray(p_seed), key_bits=key_bits,
        abundance_min=abundance_min, k=k)

    store = contiger._NodeStore(_t(s_hi), _t(s_lo),
                                torch.from_numpy(s_seed), na)
    pend = contiger._Pending(_t(p_hi), _t(p_lo), _t(p_key),
                             torch.from_numpy(p_seed), n_live_p)
    n_live = contiger._flush_pending(spec, store, pend, key_bits,
                                     abundance_min)
    assert n_live == int(n_store)
    assert (n_live > node_cap) == overflow
    assert store.n == min(n_live, node_cap) and pend.n == 0
    np.testing.assert_array_equal(bits.to_u64_np(store.hi), np.asarray(oh))
    np.testing.assert_array_equal(bits.to_u64_np(store.lo), np.asarray(ol))
    np.testing.assert_array_equal(store.seed.numpy(), np.asarray(oseed))
    assert 0 < int(store.seed.sum()) < store.n


def test_plain_fold_matches_interpreted_tpu_kernel():
    """One case at tests/test_merge128_pallas.py's kernel geometry (k = 31,
    the 4-plane encoding with its source tag)."""
    rng = np.random.default_rng(11)
    na, nb = 500, 700
    pool = _rand_kmers(rng, (na + nb) * 2 + 64)
    a_km = pool[:na]
    b_km = np.concatenate([pool[rng.choice(na, 200, replace=False)],
                           pool[na:na + nb - 200]])
    a_seed = rng.random(na) < 0.4
    b_seed = rng.random(nb) < 0.4
    pad = max(m128._pad_len(nb, L, A), L)
    with _maybe_interpret():
        out, n_live = m128.merge128_planes(
            _mk_stream(rng, a_km, a_seed, 0, pad),
            _mk_stream(rng, b_km, b_seed, 1, pad), window=L, align=A)
    n = int(n_live)
    got = np.stack([np.asarray(out[i][:n]) for i in range(4)], axis=1) \
        .astype(np.uint64)

    def stream(km, seed):
        km = km.astype(np.uint64)
        h = _t((km[:, 0] << np.uint64(32)) | km[:, 1])
        lo = _t((km[:, 2] << np.uint64(32)) | km[:, 3])
        nf = torch.from_numpy((~seed).astype(np.uint8))
        perm = kp.sort_pairs(h, lo, nf)
        return h[perm], lo[perm], nf[perm]

    ah, al, af = stream(a_km, a_seed)
    bh, bl, bf = stream(b_km, b_seed)
    cap = na + nb
    o_hi, o_lo, o_nf, n_plain = merge128_cuda.merge128(
        ah, al, af, na, bh, bl, bf, cap)
    assert int(n_plain) == n
    want_hi = (got[:, 0] << np.uint64(32)) | got[:, 1]
    want_lo = (got[:, 2] << np.uint64(32)) | (got[:, 3] & ~np.uint64(3))
    np.testing.assert_array_equal(bits.to_u64_np(o_hi[:n]), want_hi)
    np.testing.assert_array_equal(bits.to_u64_np(o_lo[:n]), want_lo)
    np.testing.assert_array_equal(o_nf[:n].numpy(),
                                  (got[:, 3] >> np.uint64(1)) & np.uint64(1))
    assert bool((o_hi[n:] == -1).all()) and bool((o_nf[n:] == 1).all())


# --------------------------------------------------------------------------
# The fold's cases of chip_smoke.py (what kernel K3 is held to on the card)
# through the wrapper on the CPU, against the JAX package's sort fold.

K3_CASES = ["m128_0", "m128_1", "m128_2", "m128_3", "long_runs",
            "seeded_both", "tiles_k47", "k63", "overflow", "empty",
            "k62_polyT", "b_all_sentinels", "b_one_kmer_stored",
            "b_one_kmer_new", "run_across_tiles_seed_in_a",
            "run_across_tiles_seed_in_b", "unaligned_views", "flush_30x"]


def _jax_sort_fold(a_hi, a_lo, a_nf, na, b_hi, b_lo, b_nf, cap):
    """The JAX package's XLA store fold (models/contiger.py:244-257) on
    (hi, lo, nflag) streams; returns numpy (hi, lo, nflag, n_live) with the
    fold's sentinel tail (nflag 1) to cap."""
    sent = jnp.uint64(SENT)
    ah = jnp.concatenate([jnp.asarray(bits.to_u64_np(a_hi[:na])),
                          jnp.asarray(bits.to_u64_np(b_hi))])
    al = jnp.concatenate([jnp.asarray(bits.to_u64_np(a_lo[:na])),
                          jnp.asarray(bits.to_u64_np(b_lo))])
    nf = jnp.concatenate([jnp.asarray(a_nf[:na].numpy()),
                          jnp.asarray(b_nf.numpy())])
    if ah.shape[0] == 0:
        return (np.full(cap, SENT), np.full(cap, SENT),
                np.ones(cap, np.uint8), 0)
    sh, sl, sf = jsp.xsort((ah, al, nf), num_keys=3)
    is_sent = (sh == sent) & (sl == sent)
    first = jnp.concatenate(
        [jnp.ones((1,), bool), (sh[1:] != sh[:-1]) | (sl[1:] != sl[:-1])])
    keep = first & ~is_sent
    kh = jnp.where(keep, sh, sent)
    kl = jnp.where(keep, sl, sent)
    kf = jnp.where(keep, jnp.uint8(1) - sf, jnp.uint8(0))
    oh, ol, of_ = jsp.xsort((kh, kl, kf), num_keys=2)
    pad = max(cap - oh.shape[0], 0)
    oh = np.concatenate([np.asarray(oh)[:cap], np.full(pad, SENT)])
    ol = np.concatenate([np.asarray(ol)[:cap], np.full(pad, SENT)])
    seed = np.concatenate([np.asarray(of_)[:cap], np.zeros(pad, np.uint8)])
    return oh, ol, 1 - seed, int(jnp.sum(keep))


def _assert_fold(got, want, what=""):
    o_hi, o_lo, o_nf, n_live = got
    w_hi, w_lo, w_nf, n_want = want
    assert int(n_live) == n_want, what
    np.testing.assert_array_equal(bits.to_u64_np(o_hi), w_hi, what)
    np.testing.assert_array_equal(bits.to_u64_np(o_lo), w_lo, what)
    np.testing.assert_array_equal(o_nf.numpy(), w_nf, what)


@pytest.fixture(scope="module")
def k3_cases():
    import chip_smoke

    cases = {name: args for name, *args in chip_smoke.k3_cases(DEV)}
    assert list(cases) == K3_CASES
    return cases


@pytest.mark.parametrize("name", K3_CASES)
def test_case_matches_jax_sort_fold(k3_cases, name):
    args = k3_cases[name]
    got = merge128_cuda.merge128(*args)
    _assert_fold(got, _jax_sort_fold(*args), name)
    na, nb, cap, n_live = args[3], args[4].numel(), args[-1], int(got[3])
    if name == "overflow":
        assert n_live > cap
    if name == "b_all_sentinels":
        assert n_live == na and bool((args[4] == -1).all())
    if name.startswith("b_one_kmer"):
        # 10,000 copies fold to one entry, seeded by the one seeded copy
        assert n_live == na + (name == "b_one_kmer_new")
        assert int((got[2][:n_live] == 0).sum()) == 1
    if name.startswith("run_across_tiles"):
        # the run's only seeded copy decides its entry, whichever stream
        # holds it
        assert int((got[2][:n_live] == 0).sum()) == 1
        assert nb > 6000 and na == 4500
    if name == "flush_30x":
        solid = int(((args[4] != -1) | (args[5] != -1)).sum())
        assert nb == 100_000 and solid == 81_000 and n_live == na + 300


@pytest.mark.parametrize("name", ["b_one_kmer_stored",
                                  "run_across_tiles_seed_in_b"])
def test_case_matches_interpreted_tpu_kernel(k3_cases, name):
    """Two of the new cases (k = 47 words cut to the kernel's 4 planes)
    through the TPU kernel in interpret mode."""
    a_hi, a_lo, a_nf, na, b_hi, b_lo, b_nf, cap = k3_cases[name]

    def planes(hi, lo, nf, tag, pad_to):
        hi, lo = bits.to_u64_np(hi), bits.to_u64_np(lo)
        live = ~((hi == SENT) & (lo == SENT))
        hi, lo, nf = hi[live], lo[live], nf.numpy()[live]
        p = np.full((pad_to, 4), 0xFFFFFFFF, np.uint32)
        n = len(hi)
        p[:n, 0] = hi >> np.uint64(32)
        p[:n, 1] = hi & np.uint64(0xFFFFFFFF)
        p[:n, 2] = lo >> np.uint64(32)
        p[:n, 3] = (lo & np.uint64(0xFFFFFFFC)).astype(np.uint32) \
            | (nf.astype(np.uint32) << 1) | np.uint32(tag)
        return tuple(jnp.asarray(p[:, i].copy()) for i in range(4))

    pad = max(m128._pad_len(max(na, b_hi.numel()), L, A), L)
    with _maybe_interpret():
        out, n_live = m128.merge128_planes(
            planes(a_hi[:na], a_lo[:na], a_nf[:na], 0, pad),
            planes(b_hi, b_lo, b_nf, 1, pad), window=L, align=A)
    n = int(n_live)
    o_hi, o_lo, o_nf, n_port = merge128_cuda.merge128(
        a_hi, a_lo, a_nf, na, b_hi, b_lo, b_nf, cap)
    assert int(n_port) == n
    got = np.stack([np.asarray(out[i][:n]) for i in range(4)],
                   axis=1).astype(np.uint64)
    np.testing.assert_array_equal(bits.to_u64_np(o_hi[:n]),
                                  (got[:, 0] << np.uint64(32)) | got[:, 1])
    np.testing.assert_array_equal(
        bits.to_u64_np(o_lo[:n]),
        (got[:, 2] << np.uint64(32)) | (got[:, 3] & ~np.uint64(3)))
    np.testing.assert_array_equal(o_nf[:n].numpy(),
                                  (got[:, 3] >> np.uint64(1)) & np.uint64(1))


def test_chain_of_folds_matches_jax_over_the_whole_capacity():
    """Six folds on one store (growing, resting, an overflow, a fold after
    it): after every step the whole capacity is what the JAX fold gives."""
    import chip_smoke

    cap = chip_smoke.K3_CHAIN["capacity"]
    store = (torch.full((cap,), -1, dtype=torch.int64),
             torch.full((cap,), -1, dtype=torch.int64),
             torch.ones(cap, dtype=torch.uint8))
    n, counts, feed = 0, [], []

    def merge(*a):
        feed.append(a[4:7])
        return merge128_cuda.merge128(*a)

    for name, out, n_live in chip_smoke.k3_chain(DEV, merge):
        _assert_fold((*out, n_live),
                     _jax_sort_fold(*store, n, *feed[-1], cap), name)
        store, n = out, min(n_live, cap)
        counts.append(n_live)
    assert len(counts) == 6
    assert counts[0] < counts[1] < counts[2] <= counts[3] < counts[2] + 100
    assert counts[4] > cap


def test_cuda_wrapper_refuses_cpu_tensors():
    a = (torch.full((8,), -1, dtype=torch.int64),
         torch.full((8,), -1, dtype=torch.int64),
         torch.ones(8, dtype=torch.uint8))
    before = merge128_cuda.LAUNCHES
    with pytest.raises(ValueError, match="GPU"):
        merge128_cuda.merge128_cuda(*a, 0, *a, 8)
    assert merge128_cuda.LAUNCHES == before


def test_node_store_flush_leaves_earlier_stores_as_they_were():
    """A flush writes its result into tensors of its own: the store's
    tensors from before it stay as they were, and the new store is live
    entries in order with a sentinel tail behind them."""
    rng = np.random.default_rng(5)
    key_bits, k, cap = 24, 47, 4096
    hi, lo = _rand_pairs(rng, 3000, k)
    kmer_key = rng.integers(0, 1 << key_bits, size=len(hi), dtype=np.uint64)
    keys = np.unique(kmer_key)
    spec = sp.from_host(keys, np.full(len(keys), 5), 1 << 12, 1 << 10,
                        key_bits, device=DEV)
    store = contiger._NodeStore(
        torch.full((cap,), -1, dtype=torch.int64),
        torch.full((cap,), -1, dtype=torch.int64),
        torch.zeros(cap, dtype=torch.uint8))

    def flush(lo_i, hi_i):
        pick = rng.integers(lo_i, hi_i, 2000)
        pend = contiger._Pending(_t(hi[pick]), _t(lo[pick]),
                                 _t(kmer_key[pick]),
                                 torch.from_numpy(
                                     (rng.random(2000) < 0.2).astype(np.uint8)),
                                 2000)
        return contiger._flush_pending(spec, store, pend, key_bits, 2)

    seen = []
    for lo_i, hi_i in ((0, 1000), (500, 2000), (1500, 3000)):
        flush(lo_i, hi_i)
        for held, kept, _ in seen:
            assert all(torch.equal(a, b) for a, b in zip(held, kept))
        assert store.n > (seen[-1][2] if seen else 500)
        held = (store.hi, store.lo, store.seed)
        seen.append((held, tuple(t.clone() for t in held), store.n))
        assert bool((store.hi[store.n:] == -1).all())
        assert bool((store.lo[store.n:] == -1).all())
        assert bool((store.seed[store.n:] == 0).all())
        live = bits.to_u64_np(store.hi[:store.n])
        assert bool((live[1:] >= live[:-1]).all())
