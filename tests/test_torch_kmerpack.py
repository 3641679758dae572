"""The port's packed k-mer ops (ops/kmerpack, ops/kmerpack_np) and ntHash
seed tables against the JAX package, bitwise, on the CPU, at the k values
where the (hi, lo) layout changes: k <= 32 fills hi only, k = 32 fills it
exactly, k >= 33 spills into lo, k = 63 leaves two free bits."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sh_assembly_tpu.ops import kmerpack as jkp
from sh_assembly_tpu.ops import kmerpack_np as jkpn
from sh_assembly_tpu.ops import nthash as jnthash
from sh_assembly_tpu_torch.ops import bits, kmerpack as kp, kmerpack_np
from sh_assembly_tpu_torch.ops import nthash

DEV = "cpu"  # the port's functions default to the GPU

KS = [21, 31, 32, 33, 47, 62, 63]


def _t(a: np.ndarray) -> torch.Tensor:
    return bits.from_u64_np(np.asarray(a, np.uint64), DEV)


def _eq(got: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    if ref.dtype == np.uint64:
        np.testing.assert_array_equal(bits.to_u64_np(got), ref)
    else:
        np.testing.assert_array_equal(got.numpy(), ref)


def _kmers(k: int, n: int = 600):
    """Packed k-mers from random reads, plus poly-A and poly-T (all-zero
    and all-ones words) and a few k-mers with the top bit set."""
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, size=(6, 150)).astype(np.uint8)
    codes[0, :k] = 0
    codes[1, :k] = 3
    hi, lo = jkp.pack_windows(jnp.asarray(codes), k)
    hi = np.asarray(hi).reshape(-1)[:n]
    lo = np.asarray(lo).reshape(-1)[:n]
    return codes, hi, lo


@pytest.mark.parametrize("k", KS)
def test_pack_revcomp_canonical_match_jax(k):
    codes, jhi, jlo = _kmers(k)
    hi, lo = kp.pack_windows(torch.from_numpy(codes), k)
    rhi, rlo = jkp.pack_windows(jnp.asarray(codes), k)
    _eq(hi, rhi)
    _eq(lo, rlo)
    th, tl = _t(jhi), _t(jlo)
    jr = jkp.revcomp_packed(jnp.asarray(jhi), jnp.asarray(jlo), k)
    r = kp.revcomp_packed(th, tl, k)
    _eq(r[0], jr[0])
    _eq(r[1], jr[1])
    jc = jkp.canonicalize(jnp.asarray(jhi), jnp.asarray(jlo), *jr)
    c = kp.canonicalize(th, tl, *r)
    for a, b in zip(c, jc):
        _eq(a, b)
    assert bool(c[2].any()) and not bool(c[2].all())
    # the host mirror (a verbatim copy) agrees with the JAX one
    for a, b in zip(kmerpack_np.revcomp_packed(jhi, jlo, k),
                    jkpn.revcomp_packed(jhi, jlo, k)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k", KS)
def test_base_ops_match_jax(k):
    _, jhi, jlo = _kmers(k)
    th, tl = _t(jhi), _t(jlo)
    jh, jl = jnp.asarray(jhi), jnp.asarray(jlo)
    _eq(kp.first_base(th, tl, k), jkp.first_base(jh, jl, k))
    _eq(kp.last_base(th, tl, k), jkp.last_base(jh, jl, k))
    for j in sorted({0, 1, k // 2, 31, 32, k - 1} & set(range(k))):
        _eq(kp.base_at(th, tl, j, k), jkp.base_at(jh, jl, j, k))
    tb = torch.from_numpy(np.arange(len(jhi)) % 4)
    for X in range(4):
        for fn, jfn in ((kp.shift_in_base, jkp.shift_in_base),
                        (kp.replace_first_base, jkp.replace_first_base)):
            got = fn(th, tl, X, k)
            ref = jfn(jh, jl, jnp.uint64(X), k)
            _eq(got[0], ref[0])
            _eq(got[1], ref[1])
    # a per-lane base tensor, as the probes pass it
    got = kp.shift_in_base(th, tl, tb, k)
    ref = jkp.shift_in_base(jh, jl, jnp.asarray(tb.numpy().astype(np.uint64)),
                            k)
    _eq(got[0], ref[0])
    _eq(got[1], ref[1])


@pytest.mark.parametrize("k", KS)
def test_join2_matches_jax(k):
    rng = np.random.default_rng(100 + k)
    _, jhi, jlo = _kmers(k)
    pairs = np.unique(np.stack([jhi, jlo], 1), axis=0)
    pairs = pairs[rng.permutation(len(pairs))]
    table, rest = pairs[:400], pairs[400:]
    # queries: table rows (some twice), absent k-mers, sentinel pairs
    q = np.concatenate([table[rng.integers(0, len(table), 500)], rest,
                        np.full((7, 2), np.uint64(0xFFFFFFFFFFFFFFFF))])
    q = q[rng.permutation(len(q))]
    ref = jkp.join2(jnp.asarray(table[:, 0]), jnp.asarray(table[:, 1]),
                    jnp.asarray(q[:, 0]), jnp.asarray(q[:, 1]))
    got = kp.join2(_t(table[:, 0]), _t(table[:, 1]), _t(q[:, 0]),
                   _t(q[:, 1]))
    assert got.dtype == torch.int32
    _eq(got, ref)
    assert int((got >= 0).sum()) == 500


def test_sort_pairs_is_unsigned_lexicographic():
    rng = np.random.default_rng(4)
    hi = rng.integers(0, 4, 3000, dtype=np.uint64) << np.uint64(62)
    lo = rng.integers(0, 1 << 64, 3000, dtype=np.uint64)
    lo[::3] = lo[1::3][: len(lo[::3])]
    nf = rng.integers(0, 2, 3000).astype(np.uint8)
    perm = kp.sort_pairs(_t(hi), _t(lo), torch.from_numpy(nf)).numpy()
    np.testing.assert_array_equal(perm, np.lexsort((nf, lo, hi)))


def test_seed_tables_match_jax():
    _eq(nthash.seed_table(DEV), jnthash.seed_table())
    _eq(nthash.cseed_table(DEV), jnthash.cseed_table())
