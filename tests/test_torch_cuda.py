"""Kernels K1 (csrc/merge_dedup.cu), K2 (csrc/count_join.cu), K3
(csrc/merge128.cu), K4 (csrc/block_sort.cu), K5 (csrc/hash_append.cu), K6
(csrc/stage_windows.cu), K7 (csrc/node_join.cu) and K8
(csrc/node_probes.cu) against their plain PyTorch versions on the GPU,
bitwise, the Contiger's probe programs on CUDA against the CPU, and the
counting stage, the Contiger, their
sharded forms (4 shards on the card), the set operations and the traveled
queries on CUDA against the CPU path.

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
from sh_assembly_tpu_torch.ops import blocksort_cuda, contract_cuda, \
    hash_append_cuda, join_cuda, members_cuda, merge128_cuda, merge_cuda, \
    node_join_cuda, probe_cuda, stage_cuda
from sh_assembly_tpu_torch.ops import kmerpack as kp
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
        mods = (join_cuda, merge128_cuda, node_join_cuda, probe_cuda)
        before = [m.LAUNCHES for m in mods]
        au = contiger.assemble_unitigs_arrays(spec, iter(stream()), params,
                                              key_bits)
        launched = tuple(m.LAUNCHES - b for m, b in zip(mods, before))
        out[str(dev)] = (au, launched)
    (ac, lc), (ag, lg) = out["cpu"], out[str(gpu)]
    assert lc == (0, 0, 0, 0)
    assert all(n > 0 for n in lg)
    assert ac.n == ag.n > 0
    for f in ("seq_codes", "offsets", "med", "after_ptr", "after_val",
              "before_ptr", "before_val"):
        np.testing.assert_array_equal(getattr(ac, f), getattr(ag, f), f)


def _mesh_reads(tmp_path):
    chip_smoke.write_fastq(str(tmp_path / "reads.fastq"), genome_len=20_000,
                           n_reads=6000, read_len=100, sub_rate=0.01,
                           n_rate=0.001, seed=3)
    return [str(tmp_path / "reads.fastq")]


def _mesh_sizing(k, rounds, threshold):
    return cfg.CounterSizing(
        k=k, qb=18, hb=26, num_true_kmers=0, num_false_kmers=0,
        n_true_kmers=1, num_deNoise=rounds, ndistinct_for_deNoise=threshold,
        end_deNoise=True, fr=0.0)


def test_sharded_counter_cuda_matches_cpu(gpu, tmp_path, monkeypatch):
    """count_sharded over 4 shards, deNoise sweeps mid-stream: the same
    keys, counts and stats on the card (through K1 and K5) as on the CPU.
    K5 launches once a shard a scan call (each shard hashes its whole
    stack at once), and never for CPU tensors."""
    from sh_assembly_tpu_torch.parallel import driver, sharded

    scans = []
    scan = sharded.ShardedCounter.append_scan

    def counted(self, *a, **kw):
        scans.append(self.n_shards)
        return scan(self, *a, **kw)

    monkeypatch.setattr(sharded.ShardedCounter, "append_scan", counted)
    files = _mesh_reads(tmp_path)
    bc = cfg.BatchConfig(reads_per_batch=512, max_read_len=104)
    out = {}
    for dev in ("cpu", gpu):
        before = (merge_cuda.LAUNCHES, hash_append_cuda.LAUNCHES)
        scans.clear()
        _, _, keys, counts, stats = driver.count_sharded(
            files, _mesh_sizing(31, 2, 20_000), n_mesh=4, batch_cfg=bc,
            super_batch=2, device=dev)
        out[str(dev)] = (keys, counts, stats, merge_cuda.LAUNCHES - before[0],
                         hash_append_cuda.LAUNCHES - before[1], sum(scans))
    (kc, cc, sc_, lc, hc, _), (kg, cg, sg, lg, hg, n_hash) = \
        out["cpu"], out[str(gpu)]
    np.testing.assert_array_equal(kc, kg)
    np.testing.assert_array_equal(cc, cg)
    assert sc_ == sg and sg["sweeps"] == 3 and sg["merges"] > 3
    assert lc == 0 and lg >= 4 * (sg["merges"] + sg["sweeps"])
    assert hc == 0 and hg == n_hash > 4


def test_sharded_contiger_cuda_matches_cpu(gpu, tmp_path):
    """contiger_sharded over 4 shards from one counted spectrum: the same
    unitig arrays on the card (through K2, K3, K6-K8, and K9 and K10 in
    the tail) as on the CPU."""
    from sh_assembly_tpu_torch.parallel import driver

    files = _mesh_reads(tmp_path)
    k = 31
    bc = cfg.BatchConfig(reads_per_batch=512, max_read_len=104)
    sizing = _mesh_sizing(k, 0, 1 << 62)
    _, _, keys, counts, _ = driver.count_sharded(
        files, sizing, n_mesh=4, batch_cfg=bc, super_batch=2, device="cpu")
    out = {}
    for dev in ("cpu", gpu):
        sc = driver.make_counter(sizing, 4, bc, device=dev)
        mods = (join_cuda, merge128_cuda, stage_cuda, node_join_cuda,
                probe_cuda, contract_cuda, members_cuda)
        before = [m.LAUNCHES for m in mods]
        au = driver.contiger_sharded(
            sc, sc.from_host(keys, counts), files,
            cfg.ContigerParams(k=k), batch_cfg=bc)
        out[str(dev)] = (au, tuple(m.LAUNCHES - b
                                   for m, b in zip(mods, before)))
    (ac, lc), (ag, lg) = out["cpu"], out[str(gpu)]
    assert lc == (0,) * 7 and lg[0] > 0 and lg[1] > 0
    assert lg[2] > 0 and lg[2] % 4 == 0  # K6: once a shard a batch
    assert lg[3] > 0 and lg[4] > 0  # K7 and K8: the mesh's joins and probes
    assert lg[5:] == (3, 1)  # the tail: K9's three calls, K10's placement
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


def test_k5_matches_plain(gpu):
    n = 0
    for case in chip_smoke.k5_cases(gpu):
        before = hash_append_cuda.LAUNCHES
        chip_smoke.k5_compare(*case)
        assert hash_append_cuda.LAUNCHES == before + 1, case[0]
        n += 1
    assert n > 20


def test_k5_redesign_edges_match_plain(gpu):
    """The edges of K5's tiling, bitwise against the plain version: rows
    of 64, 65 and 160 bases, k = 1 and 63 on rows of 63, rows of 20,000
    bases in segments with Ns on the seams and rows of length 0, k - 1
    and one window past a seam.  A stack of 160 bp rows takes shared
    memory above the 48 KB default; a long row is cut into segments."""
    names = []
    for case in chip_smoke.k5_edge_cases(gpu):
        before = hash_append_cuda.LAUNCHES
        chip_smoke.k5_compare(*case)
        assert hash_append_cuda.LAUNCHES == before + 1, case[0]
        names.append(case[0])
    for want in ("L64_packed", "L65_codes", "L160_packed", "k1_L63_codes",
                 "k63_L63_codes", "long20000_k47_packed",
                 "long20000_k63_codes"):
        assert want in names
    hot = hash_append_cuda.plan(8 * 8192, 160, 47)
    assert hot["dynamic_smem"] > 48 * 1024 and hot["blocks_per_sm"] >= 2
    assert hot["segments_per_row"] == 1 and hot["local_bytes"] == 0
    long = hash_append_cuda.plan(4, chip_smoke.K5_LONG_ROW, 63)
    assert long["rows_per_block"] == 1 and long["segments_per_row"] >= 4


def test_k5_refuses_what_the_kernel_does_not_take(gpu):
    codes, lengths = chip_smoke.k5_stack(3, 47)
    c, ln = torch.from_numpy(codes), torch.from_numpy(lengths)
    buf = torch.full((4096,), -1, dtype=torch.int64, device=gpu)
    zero = torch.zeros((), dtype=torch.int64, device=gpu)
    before = hash_append_cuda.LAUNCHES
    for kw in (dict(codes=c), dict(codes=c.to(gpu)[:2])):
        with pytest.raises(ValueError):  # a CPU tensor, a wrong shape
            hash_append_cuda.hash_append(buf, 0, zero, ln.to(gpu), 47, 36,
                                         **kw)
    with pytest.raises(ValueError):  # the CUDA wrapper takes no CPU buffer
        hash_append_cuda.hash_append_cuda(buf.cpu(), 0, zero.cpu(), ln, 47,
                                          36, codes=c)
    with pytest.raises(ValueError):  # past the buffer's end
        hash_append_cuda.hash_append(buf, 4000, zero, ln.to(gpu), 47, 36,
                                     codes=c.to(gpu))
    with pytest.raises(ValueError):  # not contiguous
        hash_append_cuda.hash_append(
            buf, 0, zero, ln.to(gpu).t().contiguous().t(), 47, 36,
            codes=c.to(gpu).transpose(0, 1).contiguous().transpose(0, 1))
    assert hash_append_cuda.LAUNCHES == before


def test_k6_matches_plain(gpu):
    """K6 against its plain version on the CPU test's geometries under both
    key rules and on its tiling's edges (rows of 8 to 20,000 bases, the
    long ones in segments), the entries around each range included."""
    names = []
    for case in chip_smoke.k6_cases(gpu):
        before = stage_cuda.LAUNCHES
        chip_smoke.k6_compare(*case)
        assert stage_cuda.LAUNCHES == before + 1, case[0]
        names.append(case[0])
    assert len(names) > 20
    for want in ("k32_L160_kb22_valid", "k63_L64_ok", "k8_L8_valid",
                 "long20000_k47_ok", "long20000_k63_valid"):
        assert want in names
    p = stage_cuda.plan(8 * 8192, 152, 47)
    assert p["dynamic_smem"] > 48 * 1024 and p["local_bytes"] == 0


def test_collect_nodes_cuda_launches_k6_per_stage_super(gpu, monkeypatch):
    """collect_nodes on the card stages each superstep with one launch of
    K6 and never the plain chain, and collects the CPU's nodes."""
    calls = []
    stage_super = contiger._stage_super
    monkeypatch.setattr(contiger, "_stage_super",
                        lambda *a: calls.append(1) or stage_super(*a))
    rng = np.random.default_rng(6)
    genome = rng.integers(0, 4, size=5000).astype(np.uint8)
    b = fastq.Batcher(47, 64, 136)
    batches = [x for s in rng.integers(0, 4870, size=900)
               for x in b.add_read(genome[s:s + 130])] + list(b.flush())
    sizing = cfg.CounterSizing(
        k=47, qb=14, hb=22, num_true_kmers=0, num_false_kmers=0,
        n_true_kmers=1, num_deNoise=0, ndistinct_for_deNoise=1 << 62,
        end_deNoise=False, fr=0.0)
    bc = cfg.BatchConfig(reads_per_batch=64, max_read_len=136)
    out = {}
    for dev in ("cpu", gpu):
        spec, _ = counter.build_spectrum(
            iter(batches), sizing, capacity=1 << 16, buf_capacity=1 << 14,
            batch_cfg=bc, device=dev)
        calls.clear()
        before = stage_cuda.LAUNCHES
        got = contiger.collect_nodes(spec, iter(batches), 47, 22, 2,
                                     super_batch=3)
        out[str(dev)] = ([t.cpu() for t in got], len(calls),
                         stage_cuda.LAUNCHES - before)
    (nc, sc_, lc), (ng, sg, lg) = out["cpu"], out[str(gpu)]
    assert lc == 0 and sc_ == sg == lg > 3
    assert nc[0].numel() > 4000
    for a, b in zip(nc, ng):
        assert torch.equal(a, b)


def test_k6_refuses_what_the_kernel_does_not_take(gpu):
    codes, lengths, seed_cols = chip_smoke.k6_stack(3, 31, 72, R=8)
    case = chip_smoke._k6_case(gpu, "r", codes, lengths, seed_cols, 31, 30,
                               0, "ok")
    _, pk, nm, ln, sc = case[:5]
    n = 8 * 42
    words = [torch.full((n,), -1, dtype=torch.int64, device=gpu)
             for _ in range(3)]
    seed = torch.zeros(n, dtype=torch.uint8, device=gpu)
    before = stage_cuda.LAUNCHES
    with pytest.raises(ValueError):  # a CPU input
        stage_cuda.stage_windows(*words, seed, 0, pk.cpu(), nm, ln, sc, 31,
                                 30)
    with pytest.raises(ValueError):  # the CUDA wrapper takes no CPU buffer
        stage_cuda.stage_windows_cuda(*(w.cpu() for w in words), seed.cpu(),
                                      0, pk.cpu(), nm.cpu(), ln.cpu(),
                                      sc.cpu(), 31, 30)
    with pytest.raises(ValueError):  # past the buffer's end
        stage_cuda.stage_windows(*words, seed, 1, pk, nm, ln, sc, 31, 30)
    with pytest.raises(ValueError):  # packed at an odd address
        odd = torch.zeros(pk.numel() + 1, dtype=torch.uint8, device=gpu)
        stage_cuda.stage_windows(*words, seed, 0, odd[1:].view(pk.shape), nm,
                                 ln, sc, 31, 30)
    assert stage_cuda.LAUNCHES == before


def test_k7_matches_plain(gpu):
    """K7 against join2_plain on the edge cases of smoke phase 16: a table
    of one pair repeated, padded stores, N and Q not powers of two, Q = 0,
    N = 1, N = 0, tables in random order at k on both sides of 32, warps
    holding several groups of equal pairs, 2^20 rows."""
    names = []
    for case in chip_smoke.k7_cases(gpu):
        before = node_join_cuda.LAUNCHES
        chip_smoke.k7_compare(*case)
        # a table built for the call (no kernel when empty) and probed
        assert node_join_cuda.LAUNCHES == before + (
            case[3].numel() > 0) * (1 + (case[1].numel() > 0))
        names.append(case[0])
    for want in ("all_duplicates", "sentinel_pads", "not_pow2", "q0", "n1",
                 "n0", "random_order_k21", "random_order_k63", "warp_groups",
                 "pads_2^20"):
        assert want in names


def test_k7_table_grows_like_plain(gpu):
    """A node table built once and grown as the closure grows its store
    (chip_smoke.k7_growth: appends inside the padded extent, filling it
    exactly, crossing it, full at the first build, repeated rows, sentinel
    queries) answers as join2_plain on the padded rows after every step;
    an append launches one insert, a crossing or a full extent a build."""
    steps = 0
    for name, *case in chip_smoke.k7_growth():
        before = dict(node_join_cuda.KINDS)
        n = chip_smoke.k7_grow_compare(gpu, name, *case)
        kinds = {k: v - before[k] for k, v in node_join_cuda.KINDS.items()}
        assert kinds["probe"] == n and kinds["build"] >= 1
        assert kinds["build"] + kinds["append"] == n
        steps += n
    assert steps == 19


def test_k8_matches_plain(gpu):
    """K8 against node_probes_plain in both modes at k = 1, 21, 31, 32, 33,
    47 and 63 with padding rows, one node and none."""
    names = []
    for case in chip_smoke.k8_cases(gpu):
        before = probe_cuda.LAUNCHES
        chip_smoke.k8_compare(*case)
        assert probe_cuda.LAUNCHES == before + (case[1].numel() > 0)
        names.append(case[0])
    assert len(names) == 18 and "k63_closure_kb22" in names


def test_k7_k8_refuse_what_the_kernels_do_not_take(gpu):
    t = torch.zeros(8, dtype=torch.int64, device=gpu)
    before = (node_join_cuda.LAUNCHES, probe_cuda.LAUNCHES)
    for args in ((t, t, t.cpu(), t), (t, t[:7], t, t), (t, t, t.int(), t),
                 (t, t, t[::2], t[::2])):
        with pytest.raises(ValueError):
            node_join_cuda.node_join(*args)
    with pytest.raises(ValueError):  # join2 routes CUDA queries to K7
        kp.join2(t.cpu(), t.cpu(), t, t)
    for args in ((t, t, 0, 22, "graph"), (t, t, 64, 22, "graph"),
                 (t, t, 47, 64, "graph"), (t, t, 47, 22, "both"),
                 (t, t[:7], 47, 22, "graph"), (t[::2], t[::2], 47, 22,
                                                "closure")):
        with pytest.raises(ValueError):
            probe_cuda.node_probes(*args)
    with pytest.raises(ValueError):  # the CUDA wrapper takes no CPU tensor
        probe_cuda.node_probes_cuda(t.cpu(), t.cpu(), 47, 22, "graph")
    assert (node_join_cuda.LAUNCHES, probe_cuda.LAUNCHES) == before


def test_probe_programs_cuda_match_cpu(gpu):
    """build_oriented_graph and a closure round (phantom_candidates) on the
    card give the CPU's tensors, each call through one launch of K8 and a
    one-shot K7 (a build and a probe) and no call of their plain
    versions."""
    rng = np.random.default_rng(13)
    genome = rng.integers(0, 4, size=6000).astype(np.uint8)
    k, kb = 47, 20  # dense keys: phantoms exist
    b = fastq.Batcher(k, 64, 136)
    batches = [x for s in rng.integers(0, 5870, size=1000)
               for x in b.add_read(genome[s:s + 130])] + list(b.flush())
    sizing = cfg.CounterSizing(
        k=k, qb=12, hb=kb, num_true_kmers=0, num_false_kmers=0,
        n_true_kmers=1, num_deNoise=0, ndistinct_for_deNoise=1 << 62,
        end_deNoise=False, fr=0.0)
    bc = cfg.BatchConfig(reads_per_batch=64, max_read_len=136)
    out = {}
    for dev in ("cpu", gpu):
        spec, _ = counter.build_spectrum(
            iter(batches), sizing, capacity=1 << 15, buf_capacity=1 << 14,
            batch_cfg=bc, device=dev)
        hi, lo, _ = contiger.collect_nodes(spec, iter(batches), k, kb, 2)
        n = hi.numel()
        pad = torch.full((1 << n.bit_length(),), -1, dtype=torch.int64,
                         device=hi.device)
        hp, lp = pad.clone(), pad.clone()
        hp[:n], lp[:n] = hi, lo
        mods = (node_join_cuda, probe_cuda)
        before = [m.LAUNCHES for m in mods]
        graph = contiger.build_oriented_graph(spec, hp, lp, k, kb, 2)
        ph = contiger.phantom_candidates(spec, hp, lp, hp, lp, k, kb, 2)
        out[str(dev)] = ([t.cpu() for t in graph + ph[:2]], ph[2:],
                         tuple(m.LAUNCHES - b for m, b in zip(mods, before)))
    (tc, nc, lc), (tg, ng, lg) = out["cpu"], out[str(gpu)]
    assert lc == (0, 0) and lg == (4, 2)
    assert nc == ng and nc[0] > 0
    for a, b in zip(tc, tg):
        assert torch.equal(a, b)
