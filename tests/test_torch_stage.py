"""The Contiger's collect staging against the JAX package's, bitwise, on
the CPU: the port's ``contiger._stage_super`` (``stage_cuda.stage_windows``,
whose CPU tensors take K6's plain version) against
``sh_assembly_tpu.models.contiger._stage_super``, and the mesh key rule
against the JAX package's masked hash planes.  Inputs come from numpy seeds:
N bases, pad past the lengths, rows of length 0 and shorter than k, seed
columns of -1, in range and out of range (``chip_smoke.k6_stack``, which
smoke phase 15 and tests/test_torch_cuda.py hold K6 against the same plain
version with), and a nonzero offset into a buffer poisoned outside the
range the call writes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from sh_assembly_tpu.models import contiger as jcontiger
from sh_assembly_tpu.ops import nthash as jnthash
from sh_assembly_tpu.ops import packio as jpackio
from sh_assembly_tpu_torch.models import contiger
from sh_assembly_tpu_torch.ops import bits, packio, stage_cuda

DEV = "cpu"  # the port's functions default to the GPU

POISON = np.uint64(0x5A5A5A5A5A5A5A5A)
U64MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def _poisoned(cap: int, n: int, m: int, seed_fill: int):
    """Buffers of cap entries poisoned outside [n, n + m) and sentinel (or 0
    for seeds) inside it, as numpy (hi, lo, key, seed)."""
    words = np.full(cap, U64MAX, np.uint64)
    words[:n] = POISON
    words[n + m:] = POISON
    seeds = np.zeros(cap, np.uint8)
    seeds[:n] = seed_fill
    seeds[n + m:] = seed_fill
    return words, words.copy(), words.copy(), seeds


def _port(bufs, n, packed, nmask, lengths, seed_cols, k, key_bits, L):
    """The port's _stage_super on the CPU -> (hi, lo, key, seed) numpy and
    the pending count after it."""
    hi, lo, key, seed = bufs
    pend = contiger._Pending(
        hi=bits.from_u64_np(hi, DEV), lo=bits.from_u64_np(lo, DEV),
        key=bits.from_u64_np(key, DEV), seed=torch.from_numpy(seed.copy()),
        n=n)
    t = torch.from_numpy
    contiger._stage_super(pend, t(packed), t(nmask), t(lengths),
                          t(seed_cols), k, key_bits, L)
    return (bits.to_u64_np(pend.hi), bits.to_u64_np(pend.lo),
            bits.to_u64_np(pend.key), pend.seed.numpy()), pend.n


def _jax(bufs, n, packed, nmask, lengths, seed_cols, k, key_bits, L):
    hi, lo, key, seed = (jnp.asarray(b) for b in bufs)
    *out, n_out = jcontiger._stage_super(
        hi, lo, key, seed, jnp.asarray(n, jnp.int64), jnp.asarray(packed),
        jnp.asarray(nmask), jnp.asarray(lengths), jnp.asarray(seed_cols),
        k, key_bits, L)
    return tuple(np.asarray(o) for o in out), int(n_out)


@pytest.mark.parametrize("L", [72, 160])
@pytest.mark.parametrize("key_bits", [22, 32, 40])
@pytest.mark.parametrize("k", [21, 31, 32, 33, 47, 63])
def test_stage_super_matches_jax(k, key_bits, L):
    codes, lengths, seed_cols = chip_smoke.k6_stack(
        1000 * k + 10 * key_bits + L, k, L)
    packed, nmask = packio.pack_np(codes)
    jp, jm = jpackio.pack_np(codes)
    assert np.array_equal(packed, jp) and np.array_equal(nmask, jm)
    R, W = codes.shape[0], L - k + 1
    n = 37  # an odd offset into the buffer
    bufs = _poisoned(n + R * W + 50, n, R * W, 3)
    got, n_got = _port(bufs, n, packed, nmask, lengths, seed_cols, k,
                       key_bits, L)
    want, n_want = _jax(bufs, n, packed, nmask, lengths, seed_cols, k,
                        key_bits, L)
    assert n_got == n_want == n + R * W
    for name, g, w, b in zip(("hi", "lo", "key", "seed"), got, want, bufs):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
        # nothing outside [n, n + R W) written
        np.testing.assert_array_equal(g[:n], b[:n], err_msg=name)
        np.testing.assert_array_equal(g[n + R * W:], b[n + R * W:],
                                      err_msg=name)
    hi, lo, key, seed = (a[n:n + R * W] for a in got)
    live = ~((hi == U64MAX) & (lo == U64MAX))
    # the case covers live windows, seeds, and sentinels of N, pad and
    # short rows; a live window's key is below 2^key_bits
    assert 0 < live.sum() < R * W and seed.sum() > 0
    assert (seed[~live] == 0).all() and (key[~live] == U64MAX).all()
    assert (key[live] < np.uint64(1 << key_bits)).all()
    if k <= 32:
        assert (lo[live] == 0).all()


@pytest.mark.parametrize("k", [31, 47, 63])
def test_mesh_key_rule(k):
    """keys="valid": every valid window's key, N-containing windows
    included, equals the JAX package's masked canonical hash planes; the
    k-mer words and seeds are the single-store rule's."""
    L, key_bits = 160, 34
    codes, lengths, seed_cols = chip_smoke.k6_stack(7 + k, k, L)
    codes[4:12, 50] = 4  # Ns inside valid windows
    packed, nmask = packio.pack_np(codes)
    R, W = codes.shape[0], L - k + 1
    t = torch.from_numpy
    outs = {}
    for rule in stage_cuda.KEY_RULES:
        hi, lo, key = (torch.full((R * W,), -1, dtype=torch.int64)
                       for _ in range(3))
        seed = torch.zeros(R * W, dtype=torch.uint8)
        assert stage_cuda.stage_windows(
            hi, lo, key, seed, 0, t(packed), t(nmask), t(lengths),
            t(seed_cols), k, key_bits, keys=rule) == R * W
        outs[rule] = [bits.to_u64_np(hi), bits.to_u64_np(lo),
                      bits.to_u64_np(key), seed.numpy()]
    for a, b in zip(outs["ok"][:2] + outs["ok"][3:],
                    outs["valid"][:2] + outs["valid"][3:]):
        np.testing.assert_array_equal(a, b)
    kh, kl, valid = jnthash.windowed_canonical_planes(
        jpackio.unpack(jnp.asarray(packed), jnp.asarray(nmask), L),
        jnp.asarray(lengths), k)
    want = (np.asarray(kh).astype(np.uint64) << np.uint64(32)) | \
        np.asarray(kl).astype(np.uint64)
    want &= np.uint64((1 << key_bits) - 1)
    want = np.where(np.asarray(valid), want, U64MAX).reshape(-1)
    np.testing.assert_array_equal(outs["valid"][2], want)
    ok_keys = outs["ok"][2] != U64MAX
    n_free_missing = (outs["valid"][2] != U64MAX) & ~ok_keys
    assert n_free_missing.sum() > 0  # valid windows holding an N
    np.testing.assert_array_equal(outs["ok"][2][ok_keys],
                                  want[ok_keys])


def test_rows_shorter_than_k_write_nothing():
    """k > L: no window, nothing written, 0 returned."""
    codes = np.zeros((4, 16), np.uint8)
    packed, nmask = (torch.from_numpy(a) for a in packio.pack_np(codes))
    ln = torch.full((4,), 16, dtype=torch.int32)
    sc = torch.full((4,), -1, dtype=torch.int32)
    pend = contiger._Pending.make(64, DEV)
    pend.n = 5
    contiger._stage_super(pend, packed, nmask, ln, sc, 21, 30, 16)
    assert pend.n == 5
    assert (pend.hi == -1).all() and (pend.seed == 0).all()


def test_stage_windows_refuses_what_it_does_not_take():
    codes, lengths, seed_cols = chip_smoke.k6_stack(3, 31, 72, R=8)
    packed, nmask = (torch.from_numpy(a) for a in packio.pack_np(codes))
    ln, sc = torch.from_numpy(lengths), torch.from_numpy(seed_cols)
    n = 8 * 42
    words = [torch.full((n,), -1, dtype=torch.int64) for _ in range(3)]
    seed = torch.zeros(n, dtype=torch.uint8)
    before = stage_cuda.LAUNCHES
    bad = [
        (words, seed, packed, nmask, ln, sc, 1),  # past the end
        (words, seed.long(), packed, nmask, ln, sc, 0),  # seed dtype
        (words, seed, packed, nmask, ln.long(), sc, 0),  # lengths dtype
        (words, seed, packed[:4], nmask, ln, sc, 0),  # rows disagree
        (words[:2] + [words[2][:-1]], seed, packed, nmask, ln, sc, 0),
    ]
    for (hi, lo, key), sd, p, m, l_, c, at in bad:
        with pytest.raises(ValueError):
            stage_cuda.stage_windows(hi, lo, key, sd, at, p, m, l_, c, 31, 30)
    with pytest.raises(ValueError):  # an unknown key rule
        stage_cuda.stage_windows(*words, seed, 0, packed, nmask, ln, sc, 31,
                                 30, keys="any")
    with pytest.raises(ValueError):  # the kernel's wrapper takes no CPU
        stage_cuda.stage_windows_cuda(*words, seed, 0, packed, nmask, ln, sc,
                                      31, 30)
    assert stage_cuda.stage_windows(*words, seed, 0, packed, nmask, ln, sc,
                                    31, 30) == n
    assert stage_cuda.LAUNCHES == before  # CPU tensors never launch


def test_collect_and_mesh_collect_stage_through_stage_windows(monkeypatch):
    """collect_nodes stages each superstep with one stage_windows call (the
    single-store key rule), the mesh collect each shard's rows with one (the
    mesh rule)."""
    from sh_assembly_tpu_torch import config as cfg
    from sh_assembly_tpu_torch.io import fastq
    from sh_assembly_tpu_torch.models import counter
    from sh_assembly_tpu_torch.ops import spectrum as sp
    from sh_assembly_tpu_torch.parallel import driver, sharded_contiger

    calls = []
    real = stage_cuda.stage_windows

    def spy(*a, **kw):
        calls.append(kw.get("keys", "ok"))
        return real(*a, **kw)

    monkeypatch.setattr(stage_cuda, "stage_windows", spy)
    supers = []
    real_super = contiger._stage_super
    monkeypatch.setattr(contiger, "_stage_super",
                        lambda *a: supers.append(1) or real_super(*a))
    rng = np.random.default_rng(4)
    genome = rng.integers(0, 4, size=3000).astype(np.uint8)
    b = fastq.Batcher(31, 64, 104)
    batches = [x for s in rng.integers(0, 2900, size=600)
               for x in b.add_read(genome[s:s + 100])] + list(b.flush())
    sizing = cfg.CounterSizing(
        k=31, qb=14, hb=22, num_true_kmers=0, num_false_kmers=0,
        n_true_kmers=1, num_deNoise=0, ndistinct_for_deNoise=1 << 62,
        end_deNoise=False, fr=0.0)
    bc = cfg.BatchConfig(reads_per_batch=64, max_read_len=104)
    spec, _ = counter.build_spectrum(iter(batches), sizing,
                                     capacity=1 << 16, buf_capacity=1 << 14,
                                     batch_cfg=bc, device=DEV)
    hi, _, _ = contiger.collect_nodes(spec, iter(batches), 31, 22, 2,
                                      super_batch=2)
    assert hi.numel() > 2000
    assert calls == ["ok"] * len(supers) and len(supers) >= 4
    calls.clear()
    sc = driver.make_counter(sizing, 2, bc, device=DEV)
    st = sharded_contiger.ShardedContiger(counter=sc, k=31,
                                          abundance_min=2,
                                          node_cap_local=1 << 12)
    specs = sc.from_host(*sp.to_host(spec, 22)[:2])
    stores = [contiger._NodeStore(
        hi=torch.full((1 << 12,), -1, dtype=torch.int64),
        lo=torch.full((1 << 12,), -1, dtype=torch.int64),
        seed=torch.zeros(1 << 12, dtype=torch.uint8)) for _ in range(2)]
    p, m = packio.pack_np(batches[0].codes)
    halves = [slice(0, 32), slice(32, 64)]
    t = torch.from_numpy
    n_live, dropped = st.collect(
        specs, stores, [t(p[h].copy()) for h in halves],
        [t(m[h].copy()) for h in halves],
        [t(batches[0].lengths[h].astype(np.int32)) for h in halves],
        [torch.full((32,), -1, dtype=torch.int32) for _ in halves], 104)
    assert calls == ["valid", "valid"]
    assert sum(n_live) > 0 and int(dropped) == 0

