"""Kernel K9, the contraction of the chain forest (``ops/contract_cuda``),
and its plain twins, bitwise.

On the CPU the dispatchers take the plain twins (``rank_plain``, torch's
``revcomp_packed`` and ``keep_plain``), held against the JAX package's
contraction (its native walk ``contract_paths_host``, numpy's
``revcomp_packed`` and ``_path_summary_np``) on ``chip_smoke.k9_cases``:
paths, cycles (of one node and of two, none starting at its least node,
with and without a splitter of K9's), padding rows, a mirrored forest,
cycles only, no edge, M = 2, at k = 21, 31, 47 and 63; and
``finalize_unitigs`` on CPU tensors against the JAX package's.  Marked
``cuda`` (skipped without a GPU): K9 against the twins, also on one path
of 2^20 oriented nodes beside 2^12 cycles, and ``finalize_unitigs`` from
CUDA tensors against CPU tensors, with K9's three calls.  The card has no
JAX, so there the tests that read it skip, and the rest run with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_contract.py
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from sh_assembly_tpu_torch import config as cfg
from sh_assembly_tpu_torch.models import contiger
from sh_assembly_tpu_torch.ops import bits, contract_cuda
from sh_assembly_tpu_torch.utils import profiling

CASES = {c[0]: c[1:] for c in chip_smoke.k9_cases()}
STEPS = ("d2h", "walk", "revcomp", "keep rule")


def jax_contiger():
    """The JAX package's Contiger, the reference (the card has no JAX)."""
    pytest.importorskip("jax")
    from sh_assembly_tpu.models import contiger as jcontiger

    return jcontiger


def jax_k9(cn, hi, lo, k):
    """The JAX package's contraction of a forest (numpy in and out) in the
    form of ``chip_smoke.k9_host``: (head, dist, tail_of, keep, rhi, rlo),
    tail_of -1 off the heads."""
    jc = jax_contiger()
    from sh_assembly_tpu.ops import kmerpack_np as jkpn

    head, dist, is_tail = jc.contract_paths_host(cn)
    rhi, rlo = jkpn.revcomp_packed(hi, lo, k)
    keep = jc._path_summary_np(head, is_tail, hi, lo, rhi, rlo)
    tail_of = np.full(len(cn), -1, np.int32)
    tail_of[head[is_tail]] = np.flatnonzero(is_tail)
    return head, dist, tail_of, keep, rhi, rlo


@pytest.fixture(scope="module")
def jax_route():
    """Each case's inputs and the JAX package's outputs."""
    return {name: (case, jax_k9(*case)) for name, case in CASES.items()}


def _tensors(cn, hi, lo, device):
    return (torch.from_numpy(cn).to(device), bits.from_u64_np(hi, device),
            bits.from_u64_np(lo, device))


@pytest.mark.parametrize("name", sorted(CASES))
def test_contract_plain_matches_host_route(jax_route, name):
    (cn, hi, lo, k), want = jax_route[name]
    before = contract_cuda.LAUNCHES
    got = contract_cuda.contract(*_tensors(cn, hi, lo, "cpu"), k)
    assert contract_cuda.LAUNCHES == before  # CPU tensors take the twins
    chip_smoke.k9_compare(name, got, want)


def test_forests_hold_what_the_cases_promise(jax_route):
    """Cycles (their nodes off their head), padding rows, shared hi words,
    and a keep rule that keeps some heads and drops others."""
    (cn, hi, lo, _), (head, dist, _, keep, _, _) = jax_route["mixed_k47"]
    # a node is on a cycle where its head has a predecessor
    has_prev = np.zeros(len(cn), bool)
    has_prev[cn[cn >= 0]] = True
    on_cycle = has_prev[head]
    assert on_cycle.sum() > 100 and (dist[on_cycle] > 0).any()
    assert (hi == chip_smoke._SENT64).sum() > 300
    assert len(np.unique(hi)) < 0.95 * len(hi)  # shared hi words
    # the keep rule keeps one of each mirror pair in the mirrored forest
    (_, _, _, _), (h2, _, _, k2, _, _) = jax_route["mirrored"]
    assert 0 < k2.sum() < (h2 == np.arange(len(h2))).sum()


def test_contract_refuses_what_it_does_not_take():
    cn = torch.full((8,), -1, dtype=torch.int32)
    w = torch.zeros(4, dtype=torch.int64)
    for args in ((cn.long(), w, w, 47), (cn, w.int(), w, 47),
                 (cn, w, w[:3], 47), (cn[:6], w, w, 47), (cn, w, w, 0),
                 (cn, w, w, 64)):
        with pytest.raises(ValueError):
            contract_cuda.contract(*args)
    # K9's wrappers take no CPU tensor
    for call in (lambda: contract_cuda.rank_cuda(cn),
                 lambda: contract_cuda.revcomp_cuda(w, w, 47),
                 lambda: contract_cuda.keep_cuda(cn, cn, w, w, w, w)):
        with pytest.raises(ValueError):
            call()
    # a target shared by two nodes, a target out of range: n_bad, which the
    # model reads and raises on
    params = cfg.ContigerParams(k=47)
    for bad in ([1, -1, 1, -1, -1, -1, -1, -1], [9, -1, -1, -1, -1, -1, -1,
                                                  -1]):
        t = torch.tensor(bad, dtype=torch.int32)
        assert contract_cuda.count_bad(t) == 1
        assert int(contract_cuda.contract(t, w, w, 47)[-1].item()) == 1
        with pytest.raises(ValueError, match="out of range or shared"):
            contiger.finalize_unitigs(w, w, np.ones(4, bool),
                                      torch.full((4,), 5, dtype=torch.int32),
                                      t, params)


def _finalize_inputs(seed, k):
    """A mirrored forest with the node counts, live mask and seed flags of
    a Contiger run -> (hi, lo, real, counts, chain_next, params, is_seed),
    numpy."""
    cn, hi, lo = chip_smoke.k9_forest(seed, 1500, k, cycles=6, mirror=True)
    rng = np.random.default_rng(seed)
    real = hi != chip_smoke._SENT64
    counts = rng.integers(2, 60, len(hi)).astype(np.int32)
    is_seed = rng.random(len(hi)) < 0.3
    params = cfg.ContigerParams(k=k, kmer_abundance_min=2)
    return hi, lo, real, counts, cn, params, is_seed


def _finalize(hi, lo, real, counts, cn, params, is_seed, device):
    """The port's ``finalize_unitigs`` on tensors on ``device`` -> (its
    unitigs, the spans it opened)."""
    profiling.reset()
    h, l = bits.from_u64_np(hi, device), bits.from_u64_np(lo, device)
    c = torch.from_numpy(counts).to(device)
    out = contiger.finalize_unitigs(h, l, real, c,
                                    torch.from_numpy(cn).to(device), params,
                                    is_seed=is_seed)
    return out, dict(profiling.GLOBAL.stats)


def jax_finalize(hi, lo, real, counts, cn, params, is_seed):
    """The JAX package's ``finalize_unitigs`` on the same forest (numpy)."""
    jc = jax_contiger()
    from sh_assembly_tpu import config as jcfg

    return jc.finalize_unitigs(hi, lo, real, counts, cn,
                               jcfg.ContigerParams(**vars(params)),
                               is_seed=is_seed)


def _same_unitigs(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("k", [21, 47, 63])
def test_finalize_unitigs_host_route_for_numpy_and_cpu_inputs(k):
    """CPU tensors take the plain twins, open each step's span once, and
    give the JAX package's unitigs on the same forest (numpy)."""
    args = _finalize_inputs(200 + k, k)
    want = jax_finalize(*args)
    before = contract_cuda.LAUNCHES
    got, stats = _finalize(*args, "cpu")
    assert contract_cuda.LAUNCHES == before
    _same_unitigs(got, want)
    assert got.n > 10
    for step in STEPS:
        assert stats[f"contiger:contract.{step}"].calls == 1
        assert stats[f"contiger:contract.{step}"].parent == "contiger:contract"


# --------------------------------------------------------------------------
# On the card

@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES) + ["long_path"])
def test_k9_matches_host_route_and_plain_twin(gpu, name):
    """K9 on the card against the plain twins on the CPU (``k9_host``)."""
    if name == "long_path":
        cn, hi, lo, k = next(c for c in chip_smoke.k9_cases(large=True)
                             if c[0] == name)[1:]
    else:
        cn, hi, lo, k = CASES[name]
    want = chip_smoke.k9_host(cn, hi, lo, k)
    args = _tensors(cn, hi, lo, gpu)
    before = contract_cuda.LAUNCHES
    got = contract_cuda.contract(*args, k)
    torch.cuda.synchronize()
    assert contract_cuda.LAUNCHES == before + 3
    chip_smoke.k9_compare(name, got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [21, 47, 63])
def test_finalize_unitigs_cuda_matches_numpy_inputs(gpu, k):
    """CUDA tensors take K9 (three calls) and give the CPU tensors' (the
    plain twins') unitigs, each step's span opened once."""
    args = _finalize_inputs(300 + k, k)
    want, _ = _finalize(*args, "cpu")
    before = contract_cuda.LAUNCHES
    got, sg = _finalize(*args, gpu)
    assert contract_cuda.LAUNCHES == before + 3
    _same_unitigs(got, want)
    for step in STEPS:
        assert sg[f"contiger:contract.{step}"].calls == 1


@pytest.mark.cuda
def test_k9_reports_a_malformed_forest(gpu):
    w = torch.zeros(4, dtype=torch.int64, device=gpu)
    for bad in ([1, -1, 1, -1, -1, -1, -1, -1], [9, -1, -1, -1, -1, -1, -1,
                                                  -1]):
        t = torch.tensor(bad, dtype=torch.int32, device=gpu)
        assert int(contract_cuda.contract(t, w, w, 47)[-1].item()) == 1
