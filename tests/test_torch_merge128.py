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
    return bits.from_u64_np(np.asarray(a, np.uint64))


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
    spec = sp.from_host(keys, counts, C, 1 << 10, key_bits)

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
