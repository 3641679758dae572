"""The port's fused counting scan against the JAX package's, bitwise, on
the CPU: ``count_batch``, ``append_scan`` and ``append_scan_packed`` (the
log buffer as ``buf_hi << 32 | buf_lo``, ``n_buf`` and ``nelts``) at
k = 21, 47 and 63 on reads with Ns, rows shorter than k, zero-length rows
and a non-zero starting fill; ``merge_maybe_sweep`` with the sweep firing
and not; and ``build_spectrum(super_batch=S)`` at S = 1, 3 and 8 against
the JAX function at the same S (store, counts, ``BuildStats`` and the
``.ser`` bytes), with stacks cut by a merge, by the deNoise trigger and a
short tail stack, and against the port's own S = 1.  Tolerance: exact.
On the CPU the port runs K5's plain twin; tests/test_torch_cuda.py holds
the kernel against it on a GPU."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from sh_assembly_tpu import config as jcfg
from sh_assembly_tpu.formats import cqf_ser as jcqf_ser
from sh_assembly_tpu.io import fastq as jfastq
from sh_assembly_tpu.models import counter as jcounter
from sh_assembly_tpu.ops import packio as jpackio
from sh_assembly_tpu.ops import spectrum as jsp
from sh_assembly_tpu_torch import config as cfg
from sh_assembly_tpu_torch.formats import cqf_ser
from sh_assembly_tpu_torch.io import fastq
from sh_assembly_tpu_torch.models import counter
from sh_assembly_tpu_torch.ops import spectrum as sp

import chip_smoke
from oracle import random_genome, reads_from_genome

DEV = "cpu"  # the port's functions default to the GPU
S, B, L = 3, 5, 72  # one geometry: chip_smoke.k5_stack's default
C, BC = 1 << 10, 1 << 12


def _state(spec) -> dict:
    """The port's spectrum as the JAX package holds it."""
    return sp.to_jax_planes(spec)


def _jstate(jspec) -> dict:
    return {f: np.asarray(getattr(jspec, f)) for f in
            ("hi", "lo", "buf_hi", "buf_lo")} | {
        f: int(getattr(jspec, f)) for f in
        ("n_main", "n_buf", "ndistinct", "nelts")}


def _assert_same(spec, jspec):
    got, want = _state(spec), _jstate(jspec)
    for f in ("n_main", "n_buf", "ndistinct", "nelts"):
        assert got[f] == want[f], f
    for f in ("hi", "lo"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    # the buffer as 64-bit words
    b = (got["buf_hi"].astype(np.uint64) << np.uint64(32)) | got["buf_lo"]
    jb = (want["buf_hi"].astype(np.uint64) << np.uint64(32)) | \
        want["buf_lo"]
    np.testing.assert_array_equal(b, jb)


def _t(a):
    import torch

    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("k,key_bits", chip_smoke.K5_GEOMETRIES)
@pytest.mark.parametrize("fn", ["count_batch", "append_scan",
                                "append_scan_packed"])
def test_append_matches_jax(fn, k, key_bits):
    # a first batch, so the stack starts at n_buf != 0
    codes0, len0 = chip_smoke.k5_stack(100 + k, k)
    codes, lengths = chip_smoke.k5_stack(200 + k, k)
    spec = counter.count_batch(sp.make(C, BC, DEV), _t(codes0[0]),
                               _t(len0[0]), k, key_bits)
    jspec = jcounter.count_batch(jsp.make(C, BC), jnp.asarray(codes0[0]),
                                 jnp.asarray(len0[0]), k, key_bits)
    assert spec.n_buf == B * (L - k + 1)
    if fn == "count_batch":
        for s in range(S):
            spec = counter.count_batch(spec, _t(codes[s]), _t(lengths[s]), k,
                                       key_bits)
            jspec = jcounter.count_batch(jspec, jnp.asarray(codes[s]),
                                         jnp.asarray(lengths[s]), k, key_bits)
            _assert_same(spec, jspec)
    elif fn == "append_scan":
        spec = counter.append_scan(spec, _t(codes), _t(lengths), k, key_bits)
        jspec = jcounter.append_scan(jspec, jnp.asarray(codes),
                                     jnp.asarray(lengths), k, key_bits)
    else:
        packed, nmask = jpackio.pack_np(codes)
        spec = counter.append_scan_packed(spec, _t(packed), _t(nmask),
                                          _t(lengths), k, key_bits, L)
        jspec = jcounter.append_scan_packed(
            jspec, jnp.asarray(packed), jnp.asarray(nmask),
            jnp.asarray(lengths), k, key_bits, L)
    _assert_same(spec, jspec)
    assert spec.n_buf == (S + 1) * B * (L - k + 1)
    # every window of the zero-length and the short row is a hole
    assert 0 < int(spec.nelts) < spec.n_buf


def test_append_scan_packed_stack_equals_its_batches():
    """One stack appended in one call writes what its batches appended
    one by one write, in batch order; a wrong max_read_len raises."""
    k, kb = 47, 36
    codes, lengths = chip_smoke.k5_stack(7, k)
    packed, nmask = jpackio.pack_np(codes)
    one = sp.make(C, BC, DEV)
    for s in range(S):
        one = counter.append_scan_packed(one, _t(packed[s:s + 1]),
                                         _t(nmask[s:s + 1]),
                                         _t(lengths[s:s + 1]), k, kb, L)
    stack = counter.append_scan_packed(sp.make(C, BC, DEV), _t(packed),
                                       _t(nmask), _t(lengths), k, kb, L)
    assert one.n_buf == stack.n_buf and int(one.nelts) == int(stack.nelts)
    assert bool((one.buf == stack.buf).all())
    with pytest.raises(ValueError):
        counter.append_scan_packed(stack, _t(packed), _t(nmask),
                                   _t(lengths), k, kb, L - 8)


@pytest.mark.parametrize("rounds,threshold", [
    (1, 0),        # fires
    (0, 0),        # no rounds left
    (2, 1 << 40),  # below the threshold
])
def test_merge_maybe_sweep_matches_jax(rounds, threshold):
    k, kb = 21, 22
    rng = np.random.default_rng(3)
    genome = rng.integers(0, 4, size=120).astype(np.uint8)
    # reads of a short genome: keys seen once and keys seen many times
    starts = rng.integers(0, 120 - L, size=(S, B))
    codes = genome[starts[..., None] + np.arange(L)]
    codes[0, 0, 30] = (codes[0, 0, 30] + 1) % 4  # a few singletons
    lengths = np.full((S, B), L, np.int32)
    spec = counter.append_scan(sp.make(C, BC, DEV), _t(codes), _t(lengths),
                               k, kb)
    jspec = jcounter.append_scan(jsp.make(C, BC), jnp.asarray(codes),
                                 jnp.asarray(lengths), k, kb)
    spec, left = counter.merge_maybe_sweep(spec, rounds, threshold, kb)
    jspec, jleft = jcounter.merge_maybe_sweep(
        jspec, jnp.asarray(rounds, jnp.int32),
        jnp.asarray(threshold, jnp.int64), kb)
    assert left == int(jleft) == rounds - (rounds == 1)
    _assert_same(spec, jspec)
    fired = rounds == 1
    counts = sp.to_host(spec, kb)[1]
    assert (counts.min() >= 2) == fired and len(counts) > 10


K, QB = 21, 14
KEY_BITS = QB + 8
READS_PER_BATCH, MAX_READ_LEN = 16, 96


@pytest.fixture(scope="module")
def reads():
    rng = np.random.default_rng(2038074761)
    genome = random_genome(rng, 2000)
    # ~30x coverage + 2% errors: a steady stream of singletons to sweep
    return reads_from_genome(rng, genome, 700, 80, error_rate=0.02)


def _batches(batcher_cls, reads):
    b = batcher_cls(K, READS_PER_BATCH, MAX_READ_LEN)
    out = []
    for r in reads:
        out.extend(b.add_read(r))
    out.extend(b.flush())
    return out


def _sizing(mod, rounds, threshold):
    return mod.CounterSizing(
        k=K, qb=QB, hb=KEY_BITS, num_true_kmers=0, num_false_kmers=0,
        n_true_kmers=1, num_deNoise=rounds, ndistinct_for_deNoise=threshold,
        end_deNoise=True, fr=0.0)


def _port_build(reads, rounds, threshold, S, monkeypatch):
    """The port's build_spectrum at super_batch S -> (spec, stats, the
    stack sizes its appends took)."""
    sizes = []
    append = counter.append_scan_packed

    def spy(spec, packed, *a):
        sizes.append(packed.shape[0])
        return append(spec, packed, *a)

    monkeypatch.setattr(counter, "append_scan_packed", spy)
    spec, stats = counter.build_spectrum(
        iter(_batches(fastq.Batcher, reads)), _sizing(cfg, rounds, threshold),
        capacity=1 << 15, buf_capacity=1 << 14, super_batch=S,
        batch_cfg=cfg.BatchConfig(READS_PER_BATCH, MAX_READ_LEN),
        device=DEV)
    monkeypatch.undo()
    return spec, stats, sizes


@pytest.mark.parametrize("S", [1, 3, 8])
@pytest.mark.parametrize("rounds,threshold", [
    (0, 1 << 62),  # stacks cut by buffer-full merges only
    (3, 1500),     # and by the tight deNoise trigger, sweeps mid-stream
])
def test_build_spectrum_super_batch_matches_jax(reads, rounds, threshold, S,
                                                monkeypatch, tmp_path):
    spec, stats, sizes = _port_build(reads, rounds, threshold, S,
                                     monkeypatch)
    jspec, jstats = jcounter.build_spectrum(
        iter(_batches(jfastq.Batcher, reads)), _sizing(jcfg, rounds,
                                                       threshold),
        capacity=1 << 15, buf_capacity=1 << 14, super_batch=S,
        batch_cfg=jcfg.BatchConfig(READS_PER_BATCH, MAX_READ_LEN))
    n = stats.batches
    assert sum(sizes) == n == 44 and n % 8 and n % 3  # a short tail stack
    if S > 1:
        # whole stacks in one append, and stacks the cadence cut
        assert S in sizes and sizes.count(1) > n % S
    if rounds:
        assert stats.sweeps >= 2 and stats.merges > stats.sweeps + 1
    # the JAX package's counters; the port's deNoise counters beside them
    # are held against the plain reference in test_torch_denoise_reference
    want = dataclasses.asdict(jstats) | {"seconds": 0}
    got = dataclasses.asdict(stats) | {"seconds": 0}
    assert {f: got[f] for f in want} == want
    assert stats.rounds == jstats.sweeps - 1  # all but the end sweep
    for a, b in zip(sp.to_host(spec, KEY_BITS), jsp.to_host(jspec, KEY_BITS)):
        np.testing.assert_array_equal(a, b)
    assert spec.n_main == int(jspec.n_main)
    assert spec.ndistinct == int(jspec.ndistinct)
    assert int(spec.nelts) == int(jspec.nelts)

    ser = []
    for mod, s in ((cqf_ser, spec), (jcqf_ser, jspec)):
        keys, counts = (sp if mod is cqf_ser else jsp).to_host(s, KEY_BITS)[:2]
        path = tmp_path / f"{mod.__name__.split('.')[0]}.ser"
        mod.write_ser(str(path), keys, counts, qb=QB, key_bits=KEY_BITS,
                      nelts=stats.kmers, ndistinct=stats.distinct)
        ser.append(path.read_bytes())
    assert ser[0] == ser[1]

    # the result does not depend on super_batch
    if S > 1:
        one, ones, _ = _port_build(reads, rounds, threshold, 1, monkeypatch)
        assert dataclasses.asdict(ones) | {"seconds": 0} == \
            dataclasses.asdict(stats) | {"seconds": 0}
        assert bool((one.store == spec.store).all())
        assert one.n_main == spec.n_main and \
            int(one.nelts) == int(spec.nelts)
