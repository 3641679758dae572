"""The mesh counter's hash through kernel K5's wrapper, on the CPU.

``ShardedCounter._keys`` (``parallel/sharded.py``) hashes a row block or a
whole stack with ``hash_append_cuda.hash_append`` into a scratch buffer.
Its keys must equal K5's plain version on the same rows and the JAX
layer's masked planes (``ops/nthash.windowed_canonical_planes`` +
``models/counter._mask_key_planes``) at k = 21, 47 and 63, on rows with
Ns, pad, rows shorter than k and empty rows.  A spy on ``hash_append``
shows that ``step`` (once a shard) and ``append_scan`` (once a shard a
scan, on the shard's whole stack) reach it, and that on CPU tensors it
dispatches to the plain version.  Tolerance: exact.  On a GPU the same
calls launch the kernel (tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sh_assembly_tpu.models import counter as jcounter
from sh_assembly_tpu.ops import nthash as jnthash
from sh_assembly_tpu_torch.ops import hash_append_cuda as ha
from sh_assembly_tpu_torch.parallel import sharded

import chip_smoke

DEV = "cpu"  # the port's functions default to the GPU
S, B, L = 3, 8, 72


def _counter(n, k, key_bits, buf=1 << 14):
    return sharded.ShardedCounter(
        mesh=sharded.make_mesh(n, DEV), k=k, key_bits=key_bits,
        local_capacity=1 << 12, local_buf_capacity=buf)


def _jax_keys(codes, lengths, k, key_bits):
    """The JAX layer's masked keys of rows [R, L] as int64 words, -1 where
    the window is invalid, flat in row then window order."""
    kh, kl, valid = jnthash.windowed_canonical_planes(
        jnp.asarray(codes), jnp.asarray(lengths), k)
    kh, kl = jcounter._mask_key_planes(kh, kl, key_bits)
    words = (np.asarray(kh).astype(np.uint64) << np.uint64(32)) | \
        np.asarray(kl).astype(np.uint64)
    return np.where(np.asarray(valid), words.view(np.int64), -1).reshape(-1)


@pytest.fixture(scope="module", params=chip_smoke.K5_GEOMETRIES,
                ids=lambda g: f"k{g[0]}")
def stack(request):
    """A stack [S, B, L] with Ns, pad, a zero-length row, rows of k - 1
    and k, a batch of nothing but empty rows, and its JAX keys."""
    k, key_bits = request.param
    codes, lengths = chip_smoke.k5_stack(300 + k, k, S, B, L)
    lengths[1, :] = 0
    want = _jax_keys(codes.reshape(-1, L), lengths.reshape(-1), k, key_bits)
    return k, key_bits, codes, lengths, want


def test_keys_match_plain_and_jax(stack):
    k, key_bits, codes, lengths, want = stack
    sc = _counter(1, k, key_bits)
    c, ln = torch.from_numpy(codes), torch.from_numpy(lengths)
    W = L - k + 1
    # the whole stack at once, and each batch alone
    got = sc._keys(c, ln)
    np.testing.assert_array_equal(got.numpy(), want)
    for s in range(S):
        one = sc._keys(c[s], ln[s])
        np.testing.assert_array_equal(one.numpy(),
                                      want[s * B * W:(s + 1) * B * W])
    buf = torch.full((S * B * W,), 7, dtype=torch.int64)
    nelts = ha.hash_append_plain(buf, 0, torch.zeros((), dtype=torch.int64),
                                 ln, k, key_bits, codes=c)
    assert torch.equal(got, buf)
    assert int(nelts) == int((want != -1).sum())
    assert got.dtype == torch.int64 and (want != -1).any() and \
        (want == -1).any()


def test_keys_take_other_dtypes(stack):
    """Lengths as int64 and codes as int32 (what a caller may hand over)
    hash as the kernel's u8 and int32 inputs do."""
    k, key_bits, codes, lengths, want = stack
    sc = _counter(1, k, key_bits)
    got = sc._keys(torch.from_numpy(codes.astype(np.int32)),
                   torch.from_numpy(lengths.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture
def spy(monkeypatch):
    """Records every call of hash_append (the rows' shape) and of its
    plain version; the CUDA wrapper must not be reached."""
    calls = {"hash_append": [], "plain": 0}
    real, plain = ha.hash_append, ha.hash_append_plain

    def hash_append(buf, n_buf, nelts, lengths, k, key_bits, **bases):
        calls["hash_append"].append(tuple(bases["codes"].shape))
        return real(buf, n_buf, nelts, lengths, k, key_bits, **bases)

    def hash_append_plain(*a, **kw):
        calls["plain"] += 1
        return plain(*a, **kw)

    def no_cuda(*a, **kw):
        raise AssertionError("the CUDA wrapper took CPU tensors")

    monkeypatch.setattr(ha, "hash_append", hash_append)
    monkeypatch.setattr(ha, "hash_append_plain", hash_append_plain)
    monkeypatch.setattr(ha, "hash_append_cuda", no_cuda)
    return calls


@pytest.mark.parametrize("n", [1, 4])
def test_step_and_scan_reach_hash_append(spy, n):
    k, key_bits = 21, 22
    codes, lengths = chip_smoke.k5_stack(41, k, S, B, L)
    sc = _counter(n, k, key_bits, buf=1 << 16)
    specs = sc.init()
    specs = sc.step(specs, *sc.shard_batch(codes[0], lengths[0]))
    assert spy["hash_append"] == [(B // n, L)] * n
    assert spy["plain"] == n
    spy["hash_append"].clear()
    specs, dropped = sc.append_scan(specs, *sc.shard_batch(codes, lengths))
    # one call a shard on its whole stack, not one a step
    assert spy["hash_append"] == [(S, B // n, L)] * n
    assert spy["plain"] == 2 * n
    assert dropped == [0] * n
    keys, counts = sc.gather_spectrum(sc.merge(specs))
    want = _jax_keys(np.concatenate([codes[:1], codes]).reshape(-1, L),
                     np.concatenate([lengths[:1], lengths]).reshape(-1), k,
                     key_bits)
    uniq, cnt = np.unique(want[want != -1].view(np.uint64),
                          return_counts=True)
    np.testing.assert_array_equal(keys, uniq)
    np.testing.assert_array_equal(counts, cnt)
