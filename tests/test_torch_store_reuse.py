"""The store's second buffer: a fold writes into the spare and hands the
store it read on as the next spare (``spectrum._fold``), and K1 fills the
output's tail only where it is dirty (``merge_dedup(out=, out_dirty=)``).
On the CPU, through K1's plain twin, against the JAX package's merge and
sweep over the whole capacity, bitwise."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from sh_assembly_tpu.ops import spectrum as jsp
from sh_assembly_tpu_torch import config as cfg
from sh_assembly_tpu_torch.io import fastq
from sh_assembly_tpu_torch.models import counter
from sh_assembly_tpu_torch.ops import bits, join_cuda, merge_cuda
from sh_assembly_tpu_torch.ops import spectrum as sp

from test_torch_spectrum import SENT, _assert_same, _jax_state

DEV = "cpu"  # the port's functions default to the GPU


def _spare_is_sound(spec, before):
    """After a fold the spare is the store the fold read, clean from its
    dirty extent on."""
    assert spec.spare is before.store
    assert spec.spare_dirty == min(before.n_main, before.capacity)
    assert bool((spec.spare[spec.spare_dirty:] == bits.SENTINEL).all())
    assert spec.store is not before.store


@pytest.mark.parametrize("key_bits", [22, 37])
def test_chain_of_folds_matches_jax_over_the_whole_capacity(key_bits):
    """Inserts, merges and sweeps on one pair of buffers: after every step
    the whole state, tail included, is the JAX package's."""
    rng = np.random.default_rng(key_bits)
    C, BC = 1 << 12, 1 << 11
    jspec = jsp.make(C, BC)
    spec = sp.from_jax_planes(**_jax_state(jspec), device=DEV)
    assert spec.spare is None
    # a small pool: most keys recur, a steady share stays singleton
    pool = rng.integers(0, 1 << key_bits, size=2500, dtype=np.uint64)
    sizes = []
    # (blocks appended, drop_singletons on the merge, sweep after it)
    for blocks, drop, sweep in [(2, False, False), (2, False, False),
                                (1, False, True), (2, False, False),
                                (1, True, False), (0, False, True),
                                (2, False, False)]:
        for _ in range(blocks):
            block = np.concatenate([
                rng.choice(pool, size=700),
                rng.integers(0, 1 << key_bits, size=200, dtype=np.uint64)])
            block[rng.random(len(block)) < 0.1] = SENT
            jspec = jsp.insert(jspec, jnp.asarray(block))
            spec = sp.insert(spec, torch.from_numpy(block.view(np.int64)))
        before = spec
        jspec = jsp._merge_xla_path(jspec, key_bits, drop)
        spec = sp.merge(spec, key_bits, drop)
        _assert_same(spec, jspec)
        _spare_is_sound(spec, before)
        sizes.append(spec.n_main)
        if sweep:
            before = spec
            jspec = jsp.sweep(jspec, key_bits)
            spec = sp.sweep(spec, key_bits)
            _assert_same(spec, jspec)
            _spare_is_sound(spec, before)
            sizes.append(spec.n_main)
    # a sweep shrank the store and a merge grew it again afterwards
    shrank = [i for i in range(1, len(sizes)) if sizes[i] < sizes[i - 1]]
    assert shrank and any(sizes[i + 1] > sizes[i] for i in shrank
                          if i + 1 < len(sizes))


def test_earlier_spectrum_readable_until_the_fold_after_next():
    rng = np.random.default_rng(3)
    kb = 30
    keys = np.unique(rng.integers(0, 1 << kb, size=400, dtype=np.uint64))
    s0 = sp.from_host(keys, np.ones(len(keys), np.int64), 2048, 512, kb,
                      device=DEV)
    kept = s0.store.clone()
    fresh = rng.integers(0, 1 << kb, size=300, dtype=np.uint64)
    s1 = sp.merge(sp.insert(s0, torch.from_numpy(fresh.view(np.int64))), kb)
    assert torch.equal(s0.store, kept)  # one fold later: untouched
    s2 = sp.sweep(s1, kb)
    assert s2.store is s0.store  # two folds later: the fold's output
    assert s2.n_main < s1.n_main


@pytest.mark.parametrize("step", range(6))
def test_plain_twin_into_reused_output_equals_fresh_output(step):
    """merge_dedup_plain(out=, out_dirty=) chained on one pair of buffers
    against the call without out, over the whole capacity."""
    reused = list(chip_smoke.k1_chain(DEV, merge_cuda.merge_dedup, True))
    fresh = list(chip_smoke.k1_chain(DEV, merge_cuda.merge_dedup_plain, False))
    assert [r[0] for r in reused] == ["merge1", "merge2", "sweep", "merge3",
                                      "overflow", "merge_after_overflow"]
    (name, out, n_live, n_drop), (_, want, n_want, d_want) = \
        reused[step], fresh[step]
    assert (n_live, n_drop) == (n_want, d_want), name
    assert torch.equal(out, want), name
    C = chip_smoke.K1_CHAIN["capacity"]
    if name == "sweep":
        assert n_live < reused[step - 1][2]
    if name == "overflow":
        assert n_live > C
    if name == "merge_after_overflow":
        assert n_live <= C


def test_plain_twin_writes_nothing_at_or_beyond_the_clean_extent():
    chip_smoke.k1_poisoned_output(DEV, merge_cuda.merge_dedup_plain)


def test_output_arguments_are_checked():
    main = torch.full((64,), -1, dtype=torch.int64)
    buf = main[:0]
    out = torch.full((64,), -1, dtype=torch.int64)
    for kw in (dict(out=out), dict(out_dirty=3), dict(out=out, out_dirty=65),
               dict(out=out, out_dirty=-1), dict(out=main, out_dirty=0),
               dict(out=out[:32], out_dirty=0),
               dict(out=out.to(torch.int32), out_dirty=0)):
        with pytest.raises(ValueError):
            merge_cuda.merge_dedup(main, buf, 0, 30, False, 64, **kw)
    got, n_live, _ = merge_cuda.merge_dedup(main, buf, 0, 30, False, 64,
                                            out=out, out_dirty=0)
    assert got is out and int(n_live) == 0


def test_cuda_wrappers_refuse_cpu_tensors():
    """On a CPU tensor the CUDA wrappers raise: no fall-back to the plain
    versions, no launch counted."""
    store = torch.full((64,), -1, dtype=torch.int64)
    before = (merge_cuda.LAUNCHES, join_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="GPU"):
        merge_cuda.merge_dedup_cuda(store, store[:0], 0, 30, False, 64)
    with pytest.raises(ValueError, match="GPU"):
        merge_cuda.merge_dedup_cuda(store, store[:0], 0, 30, False, 64,
                                    out=store.clone(), out_dirty=0)
    with pytest.raises(ValueError, match="GPU"):
        join_cuda.count_join_cuda(store, 0, store[:8], 30)
    assert (merge_cuda.LAUNCHES, join_cuda.LAUNCHES) == before


def test_build_spectrum_returns_no_spare():
    rng = np.random.default_rng(9)
    genome = rng.integers(0, 4, size=1500).astype(np.uint8)
    b = fastq.Batcher(21, 16, 96)
    batches = []
    for _ in range(300):
        s = int(rng.integers(0, len(genome) - 80))
        batches.extend(b.add_read(genome[s:s + 80].copy()))
    batches.extend(b.flush())
    sizing = cfg.CounterSizing(
        k=21, qb=14, hb=22, num_true_kmers=0, num_false_kmers=0,
        n_true_kmers=1, num_deNoise=1, ndistinct_for_deNoise=800,
        end_deNoise=True, fr=0.0)
    spec, stats = counter.build_spectrum(
        iter(batches), sizing, capacity=1 << 14, buf_capacity=1 << 12,
        batch_cfg=cfg.BatchConfig(reads_per_batch=16, max_read_len=96),
        device=DEV)
    assert stats.merges >= 3 and stats.sweeps >= 1
    assert spec.spare is None and spec.spare_dirty == 0
    assert bool((spec.store[spec.n_main:] == bits.SENTINEL).all())


def test_merge_without_room_to_sort_drops_the_spare(monkeypatch):
    """Where the buffer sort would not fit beside the spare, the merge lets
    the spare go before it sorts (in the Spectrum it was handed too) and
    folds into a fresh store: the same state as with the spare, and the
    store it read becomes the next spare as before."""
    rng = np.random.default_rng(9)
    kb = 30
    keys = np.unique(rng.integers(0, 1 << kb, size=600, dtype=np.uint64))
    blocks = [torch.from_numpy(rng.choice(keys, size=500).view(np.int64))
              for _ in range(3)]

    def chain():
        # a fresh start each time: folds write into the stores they left
        s = sp.from_host(keys, np.ones(len(keys), np.int64), 2048, 1024, kb,
                         device=DEV)
        for b in blocks:
            s = sp.merge(sp.insert(s, b), kb)
        return s

    roomy = chain()
    assert roomy.spare is not None
    monkeypatch.setattr(sp, "_room_to_sort", lambda spec: False)
    s = chain()
    for f in ("n_main", "n_buf", "ndistinct"):
        assert getattr(s, f) == getattr(roomy, f)
    assert torch.equal(s.store, roomy.store) and int(s.nelts) == \
        int(roomy.nelts)
    assert s.spare is not None
    before = sp.insert(s, blocks[0])
    spare = before.spare
    after = sp.merge(before, kb)
    assert before.spare is None and after.store is not spare
    _spare_is_sound(after, before)
