"""Kernel K11, each kept path's median, count sum and seed flag
(``ops/path_stats_cuda``), and the link join on the card through kernel K7
(``ops/links_cuda``), against their plain twins, bitwise.

On the CPU the dispatchers take the plain twins, held against the JAX
package's host assembly: its medians, sums and seed flags (the lexsort
lines of its ``_finalize_host``; ``jax_stats`` below) on
``chip_smoke.k11_cases`` (paths of one member, every length a warp takes,
lengths around the warp's and the block's limits and far beyond them,
counts over the whole range and at the cap, equal counts, even paths of
two values split at their middle, no seed mask, no path), its link joins
(``jax_links``: the table sorted with the last write winning, then three
numpy joins) on ``chip_smoke.links_cases`` (the ends of pieces of a
genome at k = 21-63, reversed pieces, siblings, palindromic paths and
repeated first k-mers, one path, no path), and ``finalize_unitigs`` on CPU
tensors against the JAX package's at k = 21, 47 and 63.  Marked ``cuda``
(skipped without a GPU): K11 and the link join against the twins on the
same cases, K11 at the E. coli cell's extent, and ``finalize_unitigs``
from CUDA tensors against CPU tensors with one launch of each.  On a
machine with a GPU (the tests that read the JAX package skip where it
cannot be imported):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_path_stats.py
"""

import numpy as np
import pytest
import torch

import chip_smoke
from sh_assembly_tpu_torch.ops import links_cuda, node_join_cuda, \
    path_stats_cuda

from test_torch_contract import _finalize, _same_unitigs, jax_finalize

K11 = {c[0]: c[1:] for c in chip_smoke.k11_cases()}
LINKS = {c[0]: c[1:] for c in chip_smoke.links_cases()}
CPU = torch.device("cpu")
STEPS = ("medians", "links")


def jax_stats(counts, starts, ai, seed, smin, smax):
    """The reference: the JAX package's per-path medians, sums and seed
    flags (``sh_assembly_tpu/models/contiger._finalize_host``, its lines
    from ``seg_id`` to ``path_seed``) on one case -> (med int64, sum int64,
    flag bool)."""
    counts_mem = counts.astype(np.int64)
    starts = starts.astype(np.int64)
    lens = np.diff(np.r_[starts, len(counts)])
    P = len(starts)
    if P == 0:
        e = np.zeros(0, np.int64)
        return e, e, np.zeros(0, bool)
    seg_id = np.repeat(np.arange(P, dtype=np.int64), lens)
    ordm = np.lexsort((counts_mem, seg_id))
    sc = counts_mem[ordm]
    mid = starts + lens // 2
    med = np.where(lens % 2 == 1, sc[mid],
                   (sc[np.maximum(mid - 1, 0)] + sc[mid]) // 2)
    total = np.add.reduceat(counts_mem, starts)
    seed_mem = (counts_mem >= smin) & (counts_mem <= smax)
    if seed is not None:
        seed_mem = seed_mem & np.asarray(seed)[ai.astype(np.int64) >> 1]
    path_seed = np.add.reduceat(seed_mem.astype(np.int64), starts) > 0
    return med, total, path_seed


def jax_links(fhi, flo, thi, tlo, k):
    """The reference: the JAX package's link table and joins
    (``_finalize_host``, its lines from ``rthi`` to ``sv8``, with its own
    ``kmerpack_np``) -> (av4, bv4, sv8) int64."""
    pytest.importorskip("jax")
    from sh_assembly_tpu.ops import kmerpack_np as kpn

    P2 = len(fhi)
    rthi, rtlo = kpn.revcomp_packed(thi, tlo, k)
    tab_hi = np.empty(2 * P2, np.uint64)
    tab_lo = np.empty(2 * P2, np.uint64)
    tab_val = np.empty(2 * P2, np.int64)
    ids1 = np.arange(P2, dtype=np.int64) + 1
    tab_hi[0::2], tab_lo[0::2], tab_val[0::2] = rthi, rtlo, -ids1
    tab_hi[1::2], tab_lo[1::2], tab_val[1::2] = fhi, flo, ids1
    ordt = np.lexsort((tab_lo, tab_hi))
    th, tl, tv = tab_hi[ordt], tab_lo[ordt], tab_val[ordt]
    last_of_run = np.ones(2 * P2, bool)
    last_of_run[:-1] = (th[1:] != th[:-1]) | (tl[1:] != tl[:-1])
    key_hi, key_lo, key_val = th[last_of_run], tl[last_of_run], \
        tv[last_of_run]
    rfhi, rflo = kpn.revcomp_packed(fhi, flo, k)
    qa = [kpn.shift_in_base(thi, tlo, X, k) for X in range(4)]
    qb = [kpn.shift_in_base(rfhi, rflo, X, k) for X in (3, 2, 1, 0)]
    qs = [kpn.replace_first_base(thi, tlo, X, k) for X in range(4)] + \
        [kpn.replace_first_base(rfhi, rflo, X, k) for X in range(4)]
    out = []
    for q in (qa, qb, qs):
        j = kpn.join(key_hi, key_lo, np.concatenate([h for h, _ in q]),
                     np.concatenate([l for _, l in q]))
        out.append(np.where(j >= 0, key_val[np.maximum(j, 0)], 0).reshape(
            len(q), P2))
    return tuple(out)


@pytest.mark.parametrize("name", sorted(K11))
def test_path_stats_plain_matches_jax_lexsort(name):
    counts, starts, ai, seed, smin, smax = K11[name]
    before = path_stats_cuda.LAUNCHES
    got = path_stats_cuda.path_stats(
        *chip_smoke.k11_inputs(counts, starts, ai, seed, CPU), smin, smax)
    assert path_stats_cuda.LAUNCHES == before  # CPU tensors take the twin
    med, total, flag = jax_stats(counts, starts, ai, seed, smin, smax)
    chip_smoke.k11_compare(name, got, (med, total, flag))


def test_k11_cases_hold_what_they_promise():
    """Lengths at and around both kernel limits, counts at the cap, paths
    of one repeated count, even medians between two values."""
    lens = {n: np.diff(np.r_[c[1], len(c[0])]) for n, c in K11.items()}
    every = np.concatenate(list(lens.values()))
    for L in (1, 2, 31, 32, 33, 4095, 4096, 4097, 20001, 70001):
        assert (every == L).any(), L
    assert (K11["at_cap"][0] == chip_smoke.K11_CAP).sum() > 1000
    assert K11["wide_counts"][0].max() > 1 << 29
    med, _, _ = jax_stats(*K11["two_values"])
    assert len(set(med.tolist())) > 3 and K11["no_seed_mask"][3] is None
    assert len(K11["no_path"][1]) == 0


@pytest.mark.parametrize("name", sorted(LINKS))
def test_links_plain_matches_jax_joins(name):
    fhi, flo, thi, tlo, k = LINKS[name]
    before = (links_cuda.LAUNCHES, node_join_cuda.LAUNCHES)
    got = links_cuda.links(*chip_smoke.links_inputs(fhi, flo, thi, tlo, k,
                                                    CPU), k)
    assert (links_cuda.LAUNCHES, node_join_cuda.LAUNCHES) == before
    want = tuple(v.astype(np.int32) for v in jax_links(fhi, flo, thi, tlo, k))
    chip_smoke.links_compare(name, got, want)


def test_link_cases_hold_what_they_promise():
    """Links of both signs in every family of probes, a palindromic path
    found as its + entry, a repeated first k-mer found as its later path."""
    from sh_assembly_tpu_torch.ops import kmerpack_np as kpn

    for name in (n for n in LINKS if n.startswith("genome")):
        fhi, flo, thi, tlo, k = LINKS[name]
        av4, bv4, sv8 = chip_smoke.links_host(fhi, flo, thi, tlo, k)
        for v in (av4, bv4, sv8):
            assert (v > 0).any() and (v < 0).any()
        rthi, rtlo = kpn.revcomp_packed(thi, tlo, k)
        pal = np.flatnonzero((fhi == rthi) & (flo == rtlo))
        found = np.concatenate([av4.ravel(), bv4.ravel(), sv8.ravel()])
        assert np.isin(pal + 1, found).any()
        assert not np.isin(-(pal + 1), found).any()
        key = fhi.astype(object) << 64 | flo.astype(object)
        first = {}
        later = [p for p, x in enumerate(key) if first.setdefault(x, p) != p]
        assert later and not np.isin([first[key[p]] + 1 for p in later],
                                     found).any()
        assert np.isin(np.array(later) + 1, found).any()


def _forest_inputs(seed, k):
    """A mirrored forest with 40 palindromic heads, paths beyond K11's
    in-block limit, a tenth of the counts at the cap and seed flags ->
    ``_finalize``'s (hi, lo, real, counts, chain_next, params, is_seed)."""
    from sh_assembly_tpu_torch import config as cfg

    cn, hi, lo, real, counts = chip_smoke.k10_forest(
        seed, 30000, k, long_paths=(4500, 5001), cycles=12, mirror=True,
        palindromes=40)
    rng = np.random.default_rng(seed)
    counts[rng.random(len(counts)) < 0.1] = chip_smoke.K11_CAP
    is_seed = rng.random(len(hi)) < 0.3
    params = cfg.ContigerParams(k=k, kmer_abundance_min=2,
                                solid_kmer_abundance_max=chip_smoke.K11_CAP)
    return hi, lo, real, counts, cn, params, is_seed


@pytest.mark.parametrize("k", [21, 47, 63])
def test_finalize_unitigs_twins_match_jax(k, monkeypatch):
    """CPU tensors take both plain twins, one call each inside their spans,
    and give the JAX package's unitigs: medians, means, links, offsets,
    sequences."""
    calls = []
    for mod, name in ((path_stats_cuda, "path_stats_plain"),
                      (links_cuda, "links_plain")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, fn=fn, name=name: (
            calls.append(name), fn(*a))[1])
    args = _forest_inputs(600 + k, k)
    before = (path_stats_cuda.LAUNCHES, links_cuda.LAUNCHES)
    got, stats = _finalize(*args, "cpu")
    assert (path_stats_cuda.LAUNCHES, links_cuda.LAUNCHES) == before
    assert sorted(calls) == ["links_plain", "path_stats_plain"]
    assert got.n > 100 and got.n_palindromes > 0
    assert (got.med >= chip_smoke.K11_CAP // 2).any()
    for step in STEPS:
        s = stats[f"contiger:host assembly.{step}"]
        assert s.calls == 1 and s.parent == "contiger:host assembly"
    _same_unitigs(got, jax_finalize(*args))


def test_finalize_unitigs_takes_a_seed_mask_tensor():
    """A seed mask given as a tensor (the Contiger's own, on the device of
    its collect) gives the numpy mask's unitigs."""
    args = list(_forest_inputs(640, 47))
    want, _ = _finalize(*args, "cpu")
    args[-1] = torch.from_numpy(args[-1]).to(torch.uint8)
    got, _ = _finalize(*args, "cpu")
    _same_unitigs(got, want)


def test_dispatchers_refuse_what_they_do_not_take():
    counts, starts, ai, seed = chip_smoke.k11_inputs(*K11["mixed"][:4], CPU)
    for bad in ((counts.long(), starts, ai, seed), (counts, starts.long(),
                                                    ai, seed),
                (counts, starts, ai[:-1], seed), (counts, starts, ai,
                                                  seed.int()),
                (counts[:0], starts, ai[:0], seed)):
        with pytest.raises(ValueError):
            path_stats_cuda.path_stats(*bad, 3, 40)
    with pytest.raises(ValueError):
        path_stats_cuda.path_stats(counts, starts, ai, seed, 1 << 63, 40)
    with pytest.raises(ValueError):  # K11's wrapper takes no CPU tensor
        path_stats_cuda.path_stats_cuda(counts, starts, ai, seed, 3, 40)
    ends = list(chip_smoke.links_inputs(*LINKS["genome_k47"][:4], 47, CPU))
    for i, bad in ((0, ends[0].int()), (3, ends[3][:-1]), (5, ends[5][::2])):
        with pytest.raises(ValueError):
            links_cuda.links(*(ends[:i] + [bad] + ends[i + 1:]), 47)
    for k in (0, 64):
        with pytest.raises(ValueError):
            links_cuda.links(*ends, k)
    with pytest.raises(ValueError):  # K7's route takes no CPU tensor
        links_cuda.links_cuda(*ends, 47)


# --------------------------------------------------------------------------
# On the card

@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(K11))
def test_k11_matches_plain(gpu, name):
    """K11 on the card against the plain twin on the CPU (``k11_host``) and
    on the card."""
    counts, starts, ai, seed, smin, smax = K11[name]
    want = chip_smoke.k11_host(counts, starts, ai, seed, smin, smax)
    args = chip_smoke.k11_inputs(counts, starts, ai, seed, gpu)
    before = path_stats_cuda.LAUNCHES
    got = path_stats_cuda.path_stats(*args, smin, smax)
    assert path_stats_cuda.LAUNCHES == before + 1
    chip_smoke.k11_compare(name, got, want)
    chip_smoke.k11_compare(name, path_stats_cuda.path_stats_plain(
        *args, smin, smax), want)


@pytest.mark.cuda
def test_k11_at_the_cell_extent(gpu):
    """K11 on K10's members of the E. coli cell's extent (phase 17's
    forest) against the plain twin on the card."""
    from sh_assembly_tpu_torch.ops import members_cuda

    _, *case = next(c for c in chip_smoke.k10_cases(large=True)
                    if c[0] == "cell_extent")
    ai, _, _, _, counts, starts, _ = members_cuda.members(
        *chip_smoke.k10_inputs(*case, gpu), case[-1])
    seed = torch.rand(len(case[1]), device=gpu) < 0.3
    want = tuple(t.cpu().numpy() for t in path_stats_cuda.path_stats_plain(
        counts, starts, ai, seed, 10, 50))
    got = path_stats_cuda.path_stats(counts, starts, ai, seed, 10, 50)
    chip_smoke.k11_compare("the cell's extent", got, want)
    assert int(torch.diff(starts).max()) > 4096


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(LINKS))
def test_links_cuda_matches_plain(gpu, name):
    """The link join through K7 (one build and one probe) against the plain
    twin on the CPU (``links_host``) and on the card."""
    fhi, flo, thi, tlo, k = LINKS[name]
    want = chip_smoke.links_host(fhi, flo, thi, tlo, k)
    args = chip_smoke.links_inputs(fhi, flo, thi, tlo, k, gpu)
    before = links_cuda.LAUNCHES, dict(node_join_cuda.KINDS)
    got = links_cuda.links(*args, k)
    n = int(len(fhi) > 0)
    assert links_cuda.LAUNCHES == before[0] + n
    assert {x: node_join_cuda.KINDS[x] - before[1][x] for x in before[1]} \
        == {"build": n, "append": 0, "probe": n}
    chip_smoke.links_compare(name, got, want)
    chip_smoke.links_compare(name, links_cuda.links_plain(*args, k), want)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [21, 47, 63])
def test_finalize_unitigs_cuda_k11_links_match_cpu(gpu, k, tmp_path):
    """CUDA tensors take K11 and the link join (one launch each) and give
    the CPU tensors' (the plain twins') unitigs and unitigs.fa."""
    args = _forest_inputs(700 + k, k)
    want, _ = _finalize(*args, "cpu")
    before = (path_stats_cuda.LAUNCHES, links_cuda.LAUNCHES)
    got, stats = _finalize(*args, gpu)
    assert (path_stats_cuda.LAUNCHES, links_cuda.LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    _same_unitigs(got, want)
    files = []
    for name, u in (("cuda", got), ("cpu", want)):
        files.append(tmp_path / f"{name}.fa")
        u.write_fasta(str(files[-1]))
    assert files[0].read_bytes() == files[1].read_bytes()
    for step in STEPS:
        assert stats[f"contiger:host assembly.{step}"].calls == 1
    # a seed mask on the other device than the forest's follows the forest
    args = list(args)
    args[-1] = torch.from_numpy(args[-1]).to(gpu)
    _same_unitigs(_finalize(*args, "cpu")[0], want)
    args[-1] = args[-1].cpu()
    _same_unitigs(_finalize(*args, gpu)[0], want)
