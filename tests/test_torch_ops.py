"""The port's elementwise ops against the JAX package, bitwise, on the CPU:
2-bit unpack, the windowed canonical ntHash and the key mask, and the
unsigned-on-int64 helpers they rest on."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sh_assembly_tpu.models import counter as jcounter
from sh_assembly_tpu.ops import nthash as jnthash
from sh_assembly_tpu.ops import packio as jpackio
from sh_assembly_tpu.utils import nthash as host_nthash
from sh_assembly_tpu_torch.ops import bits, nthash, packio

DEV = "cpu"  # the port's functions default to the GPU

def _codes(rng, B, L, n_rate=0.03):
    """Random reads with N codes, ragged lengths and pad (5) tails."""
    codes = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    codes[rng.random((B, L)) < n_rate] = 4
    lengths = rng.integers(0, L + 1, size=B).astype(np.int32)
    lengths[0] = L
    for b in range(B):
        codes[b, lengths[b]:] = 5
    return codes, lengths


@pytest.mark.parametrize("shape", [(5, 160), (2, 3, 96), (1, 8)])
def test_unpack_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    codes = rng.integers(0, 6, size=shape).astype(np.uint8)
    p, m = packio.pack_np(codes)
    jp, jm = jpackio.pack_np(codes)
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_array_equal(m, jm)
    L = shape[-1]
    got = packio.unpack(torch.from_numpy(p), torch.from_numpy(m), L)
    ref = np.asarray(jpackio.unpack(jnp.asarray(p), jnp.asarray(m), L))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("k", [28, 31, 47, 63])
def test_windowed_canonical_matches_planes(k):
    rng = np.random.default_rng(k)
    codes, lengths = _codes(rng, 9, 160)
    kh, kl, jvalid = jnthash.windowed_canonical_planes(
        jnp.asarray(codes), jnp.asarray(lengths), k)
    ref = (np.asarray(kh).astype(np.uint64) << np.uint64(32)) | \
        np.asarray(kl).astype(np.uint64)
    keys, valid = nthash.windowed_canonical(
        torch.from_numpy(codes), torch.from_numpy(lengths), k)
    np.testing.assert_array_equal(bits.to_u64_np(keys), ref)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))


@pytest.mark.parametrize("k,key_bits", [(28, 20), (31, 32), (47, 37),
                                        (63, 48)])
def test_mask_keys_matches_mask_key_planes(k, key_bits):
    rng = np.random.default_rng(key_bits)
    codes, lengths = _codes(rng, 4, 96)
    kh, kl, _ = jnthash.windowed_canonical_planes(
        jnp.asarray(codes), jnp.asarray(lengths), k)
    mh, ml = jcounter._mask_key_planes(kh, kl, key_bits)
    ref = (np.asarray(mh).astype(np.uint64) << np.uint64(32)) | \
        np.asarray(ml).astype(np.uint64)
    keys, _ = nthash.windowed_canonical(
        torch.from_numpy(codes), torch.from_numpy(lengths), k)
    got = nthash.mask_keys(keys, key_bits)
    assert bool((got >= 0).all())
    np.testing.assert_array_equal(bits.to_u64_np(got), ref)


def test_unsigned_helpers_match_numpy():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 1 << 64, size=4096, dtype=np.uint64)
    x[:4] = [0, 1, 1 << 63, 0xFFFFFFFFFFFFFFFF]
    s = rng.integers(0, 64, size=4096).astype(np.uint64)
    tx = bits.from_u64_np(x, DEV)
    ts = torch.from_numpy(s.astype(np.int64))
    np.testing.assert_array_equal(bits.to_u64_np(bits.rol_t(tx, ts)),
                                  host_nthash.rol(x, s))
    with np.errstate(over="ignore"):
        np.testing.assert_array_equal(bits.to_u64_np(bits.srl_t(tx, ts)),
                                      x >> s)
    for c in (0, 1, 8, 37, 63):
        np.testing.assert_array_equal(bits.to_u64_np(bits.srl(tx, c)),
                                      x >> np.uint64(c))
    y = rng.integers(0, 1 << 64, size=4096, dtype=np.uint64)
    np.testing.assert_array_equal(
        bits.to_u64_np(bits.umin(tx, bits.from_u64_np(y, DEV))),
        np.minimum(x, y))
    np.testing.assert_array_equal(bits.to_u64_np(bits.usort(tx)), np.sort(x))
