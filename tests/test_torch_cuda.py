"""Kernels K1 (csrc/merge_dedup.cu), K2 (csrc/count_join.cu), K3
(csrc/merge128.cu) and K4 (csrc/block_sort.cu) against their plain PyTorch
versions on the GPU, bitwise, and the counting stage, the Contiger, the
set operations and the traveled queries on CUDA against the CPU path.

Marked ``cuda``: without a GPU every test here skips.  On a machine with
one (no JAX needed; the repository's conftest imports JAX, so skip it):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import chip_smoke
from sh_assembly_tpu_torch import config as cfg
from sh_assembly_tpu_torch.io import fastq
from sh_assembly_tpu_torch.models import counter
from sh_assembly_tpu_torch.models import contiger
from sh_assembly_tpu_torch.ops import blocksort_cuda, join_cuda, \
    merge128_cuda, merge_cuda
from sh_assembly_tpu_torch.ops import spectrum as sp

pytestmark = pytest.mark.cuda


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    return torch.device("cuda", 0)


def test_k1_matches_plain_twin(gpu):
    n = 0
    for name, main, buf, n_main, kb, drop, C in chip_smoke.k1_cases(gpu):
        before = merge_cuda.LAUNCHES
        ok, nk, dk = merge_cuda.merge_dedup(main, buf, n_main, kb, drop, C)
        assert merge_cuda.LAUNCHES == before + 1
        op, np_, dp = merge_cuda.merge_dedup_plain(main, buf, n_main, kb,
                                                   drop, C)
        assert int(nk) == int(np_), name
        assert int(dk) == int(dp), name
        assert torch.equal(ok, op), name
        n += 1
    assert n > 20


def test_k1_chain_on_reused_buffers_matches_plain_twin(gpu):
    """Folds chained on one pair of buffers (merge, merge, a sweep that
    shrinks the store, merge, an overflow, a merge after it): the whole
    capacity equals the twin's fresh output after every step."""
    before = merge_cuda.LAUNCHES
    steps = list(zip(
        chip_smoke.k1_chain(gpu, merge_cuda.merge_dedup, reuse=True),
        chip_smoke.k1_chain(gpu, merge_cuda.merge_dedup_plain, reuse=False)))
    assert merge_cuda.LAUNCHES == before + len(steps) == before + 6
    for (name, out, n_live, n_drop), (_, want, n_want, d_want) in steps:
        assert (n_live, n_drop) == (n_want, d_want), name
        assert torch.equal(out, want), name
    counts = [s[0][2] for s in steps]
    C = chip_smoke.K1_CHAIN["capacity"]
    assert counts[2] < counts[1] and counts[4] > C >= counts[5]


def test_k1_writes_nothing_at_or_beyond_the_clean_extent(gpu):
    chip_smoke.k1_poisoned_output(gpu, merge_cuda.merge_dedup)


def test_k1_k2_refuse_what_the_kernels_do_not_take(gpu):
    store = torch.full((64,), -1, dtype=torch.int64, device=gpu)
    out = torch.full((64,), -1, dtype=torch.int64, device=gpu)
    before = (merge_cuda.LAUNCHES, join_cuda.LAUNCHES)
    for kw in (dict(out=out), dict(out=out, out_dirty=65),
               dict(out=store, out_dirty=0), dict(out=out.cpu(), out_dirty=0)):
        with pytest.raises(ValueError):
            merge_cuda.merge_dedup(store, store[:0], 0, 30, False, 64, **kw)
    # the CUDA wrappers never fall back to the plain versions
    with pytest.raises(ValueError):
        merge_cuda.merge_dedup_cuda(store.cpu(), store[:0].cpu(), 0, 30,
                                    False, 64)
    with pytest.raises(ValueError):
        join_cuda.count_join_cuda(store.cpu(), 0, store[:8].cpu(), 30)
    assert (merge_cuda.LAUNCHES, join_cuda.LAUNCHES) == before


def test_build_spectrum_cuda_matches_cpu(gpu):
    rng = np.random.default_rng(5)
    genome = rng.integers(0, 4, size=3000).astype(np.uint8)
    reads = []
    for _ in range(900):
        s = int(rng.integers(0, len(genome) - 90))
        r = genome[s:s + 90].copy()
        err = rng.random(90) < 0.02
        r[err] = (r[err] + 1) % 4
        reads.append(r)
    sizing = cfg.CounterSizing(
        k=21, qb=14, hb=22, num_true_kmers=0, num_false_kmers=0,
        n_true_kmers=1, num_deNoise=2, ndistinct_for_deNoise=2000,
        end_deNoise=True, fr=0.0)
    bc = cfg.BatchConfig(reads_per_batch=16, max_read_len=96)
    out = {}
    for dev in ("cpu", gpu):
        b = fastq.Batcher(21, 16, 96)
        batches = [x for r in reads for x in b.add_read(r)] + list(b.flush())
        spec, stats = counter.build_spectrum(
            iter(batches), sizing, capacity=1 << 15, buf_capacity=1 << 12,
            batch_cfg=bc, device=dev)
        assert spec.spare is None  # counting hands on one buffer only
        out[str(dev)] = (sp.to_host(spec, 22), stats)
    (hc, sc), (hg, sg) = out["cpu"], out[str(gpu)]
    assert sc.sweeps >= 2 and sc.merges > 3
    for f in ("merges", "sweeps", "kmers", "distinct"):
        assert getattr(sc, f) == getattr(sg, f), f
    for a, b in zip(hc, hg):
        np.testing.assert_array_equal(a, b)


def test_k2_matches_plain(gpu):
    n = 0
    for name, store, n_main, q, kb in chip_smoke.k2_cases(gpu):
        before = join_cuda.LAUNCHES
        got = join_cuda.count_join(store, n_main, q, kb)
        assert join_cuda.LAUNCHES == before + 1
        want = join_cuda.count_join_plain(store, n_main, q, kb)
        assert torch.equal(got, want), name
        n += 1
    # among them: tiles with a wide, an empty and a boundary-aligned store
    # range, duplicate queries, unaligned views
    assert n >= 17


def test_k3_matches_plain(gpu):
    n = 0
    for name, *args in chip_smoke.k3_cases(gpu):
        before = merge128_cuda.LAUNCHES
        got = merge128_cuda.merge128(*args)
        assert merge128_cuda.LAUNCHES == before + 1
        want = merge128_cuda.merge128_plain(*args)
        assert int(got[3]) == int(want[3]), name
        for a, b in zip(got[:3], want[:3]):
            assert torch.equal(a, b), name
        n += 1
    # among them: a stream of sentinels only, of one k-mer only, runs
    # across tiles seeded in either stream, views at odd offsets, a flush
    # with 30 copies a k-mer and a sentinel tail
    assert n >= 18


def test_k3_chain_of_folds_matches_plain(gpu):
    """Folds chained on one store (growing, resting, an overflow, a fold
    after it): the whole capacity equals the plain version's after every
    step."""
    before = merge128_cuda.LAUNCHES
    steps = list(zip(
        chip_smoke.k3_chain(gpu, merge128_cuda.merge128),
        chip_smoke.k3_chain(gpu, merge128_cuda.merge128_plain)))
    assert merge128_cuda.LAUNCHES == before + len(steps) == before + 6
    for (name, out, n_live), (_, want, n_want) in steps:
        assert n_live == n_want, name
        for o, w in zip(out, want):
            assert torch.equal(o, w), name
    assert steps[4][0][2] > chip_smoke.K3_CHAIN["capacity"]


def test_k3_real_shapes_match_plain(gpu):
    """The shape a flush hands the fold (59.8 M sorted candidates, 4.1
    copies a k-mer, a sentinel tail) against a 12.1 M-entry store and
    against an empty one."""
    from sh_assembly_tpu_torch.profile import kernels as pk

    flush = pk.k3_flush_case(gpu)
    for args in (flush, (*flush[:3], 0, *flush[4:])):
        got = merge128_cuda.merge128(*args)
        want = merge128_cuda.merge128_plain(*args)
        assert int(got[3]) == int(want[3])
        for a, b in zip(got[:3], want[:3]):
            assert torch.equal(a, b)
        del got, want


def test_k3_refuses_what_the_kernel_does_not_take(gpu):
    a = (torch.full((64,), -1, dtype=torch.int64, device=gpu),
         torch.full((64,), -1, dtype=torch.int64, device=gpu),
         torch.ones(64, dtype=torch.uint8, device=gpu))
    before = merge128_cuda.LAUNCHES
    for bad in ((a[0][::2], *a[1:], 0, *a, 64),       # not contiguous
                (a[0], a[1], a[2].long(), 0, *a, 64),  # flag dtype
                (*a, 65, *a, 64),                      # na beyond stream a
                (*a, 0, a[0], a[1][:32], a[2], 64)):   # lengths differ
        with pytest.raises(ValueError):
            merge128_cuda.merge128(*bad)
    # the CUDA wrapper never falls back to the plain version
    with pytest.raises(ValueError):
        merge128_cuda.merge128_cuda(*(t.cpu() for t in a), 0,
                                    *(t.cpu() for t in a), 64)
    assert merge128_cuda.LAUNCHES == before


@pytest.mark.parametrize("k", [21, 47, 63])
def test_contiger_cuda_matches_cpu(gpu, k):
    rng = np.random.default_rng(k)
    genome = rng.integers(0, 4, size=4000).astype(np.uint8)
    reads = []
    # 130 bp reads: the middle k-mer (the traversal seed) fits at k = 63
    for _ in range(700):
        s = int(rng.integers(0, len(genome) - 130))
        r = genome[s:s + 130].copy()
        if rng.random() < 0.5:
            r = (3 - r)[::-1].copy()
        err = rng.random(130) < 0.01
        r[err] = (r[err] + 1) % 4
        reads.append(r)
    key_bits = 22  # dense enough for phantom nodes
    sizing = cfg.CounterSizing(
        k=k, qb=14, hb=key_bits, num_true_kmers=0, num_false_kmers=0,
        n_true_kmers=1, num_deNoise=0, ndistinct_for_deNoise=1 << 62,
        end_deNoise=False, fr=0.0)
    bc = cfg.BatchConfig(reads_per_batch=64, max_read_len=136)
    params = cfg.ContigerParams(k=k)

    def stream():
        b = fastq.Batcher(k, 64, 136)
        return [x for r in reads for x in b.add_read(r)] + list(b.flush())

    out = {}
    for dev in ("cpu", gpu):
        spec, _ = counter.build_spectrum(
            iter(stream()), sizing, capacity=1 << 16, buf_capacity=1 << 14,
            batch_cfg=bc, device=dev)
        before = (join_cuda.LAUNCHES, merge128_cuda.LAUNCHES)
        au = contiger.assemble_unitigs_arrays(spec, iter(stream()), params,
                                              key_bits)
        launched = (join_cuda.LAUNCHES - before[0],
                    merge128_cuda.LAUNCHES - before[1])
        out[str(dev)] = (au, launched)
    (ac, lc), (ag, lg) = out["cpu"], out[str(gpu)]
    assert lc == (0, 0)
    assert lg[0] > 0 and lg[1] > 0
    assert ac.n == ag.n > 0
    for f in ("seq_codes", "offsets", "med", "after_ptr", "after_val",
              "before_ptr", "before_val"):
        np.testing.assert_array_equal(getattr(ac, f), getattr(ag, f), f)


def test_k4_matches_plain(gpu):
    n = 0
    for name, x, W in chip_smoke.k4_cases(gpu):
        before = blocksort_cuda.LAUNCHES
        got = blocksort_cuda.block_sort(x, W)
        assert blocksort_cuda.LAUNCHES == before + 1
        assert torch.equal(got, blocksort_cuda.block_sort_plain(x, W)), name
        ref = np.sort(x.cpu().numpy().view(np.uint32).reshape(-1, W), axis=1)
        np.testing.assert_array_equal(
            got.cpu().numpy().view(np.uint32), ref.reshape(-1), name)
        n += 1
    # windows of 2^7 to 2^19: in a block, in a cluster of two and of four,
    # above the cluster; 35 windows of 2^17 are more than fit at once
    assert n >= 60


def test_k4_refuses_what_the_kernel_does_not_take(gpu):
    x = torch.zeros(1024, dtype=torch.int32, device=gpu)
    before = blocksort_cuda.LAUNCHES
    for bad, W in ((x[:768], 384), (x, 64), (x[:640], 256), (x.long(), 128),
                   (x[::2], 128)):
        with pytest.raises(ValueError):
            blocksort_cuda.block_sort(bad, W)
    assert blocksort_cuda.LAUNCHES == before


def test_library_surface_cuda_matches_cpu(gpu):
    kb = 37
    a, b = chip_smoke.setops_pair(gpu, 300_000, 1 << 19, kb)
    # CUDA = CPU for the set operations and the traveled queries, with
    # inner_product and intersect launching K2 on the card only
    chip_smoke.library_cut(gpu, a, b, kb, m=100_000, Cm=1 << 17)
