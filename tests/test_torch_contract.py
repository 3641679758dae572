"""Kernel K9, the contraction of the chain forest (``ops/contract_cuda``),
against the host route of ``finalize_unitigs`` (the native walk
``contract_paths_host``, numpy's ``revcomp_packed`` and
``_path_summary_np``), bitwise.

On the CPU the plain twin (``contract_plain``: ``contract_paths``, torch's
``revcomp_packed`` and ``keep_rule_plain``) is held against the host route
on ``chip_smoke.k9_cases``: paths, cycles (of one node and of two, none
starting at its least node, with and without a splitter of K9's), padding
rows, a mirrored forest, cycles only, no edge, M = 2, at k = 21, 31, 47 and
63; and ``finalize_unitigs`` keeps its host route for numpy and CPU
inputs.  Marked ``cuda`` (skipped without a GPU): K9 against the host route
and the plain twin on the card, also on one path of 2^20 oriented nodes
beside 2^12 cycles, and ``finalize_unitigs`` from CUDA tensors against
numpy inputs, with its K9 span.  No JAX here, so the card's tests run with

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
K9_SPAN = "contiger:contract.walk.k9"


@pytest.fixture(scope="module")
def host_route():
    """Each case's inputs and the host route's outputs."""
    return {name: (case, chip_smoke.k9_host(*case))
            for name, case in CASES.items()}


def _tensors(cn, hi, lo, device):
    return (torch.from_numpy(cn).to(device), bits.from_u64_np(hi, device),
            bits.from_u64_np(lo, device))


@pytest.mark.parametrize("name", sorted(CASES))
def test_contract_plain_matches_host_route(host_route, name):
    (cn, hi, lo, k), want = host_route[name]
    before = contract_cuda.LAUNCHES
    got = contract_cuda.contract(*_tensors(cn, hi, lo, "cpu"), k)
    assert contract_cuda.LAUNCHES == before  # CPU tensors take the twin
    chip_smoke.k9_compare(name, got, want)


def test_forests_hold_what_the_cases_promise(host_route):
    """Cycles (their nodes off their head), padding rows, shared hi words,
    and a keep rule that keeps some heads and drops others."""
    (cn, hi, lo, _), (head, dist, keep, _, _) = host_route["mixed_k47"]
    # a node is on a cycle where its head has a predecessor
    has_prev = np.zeros(len(cn), bool)
    has_prev[cn[cn >= 0]] = True
    on_cycle = has_prev[head]
    assert on_cycle.sum() > 100 and (dist[on_cycle] > 0).any()
    assert (hi == chip_smoke._SENT64).sum() > 300
    assert len(np.unique(hi)) < 0.95 * len(hi)  # shared hi words
    # the keep rule keeps one of each mirror pair in the mirrored forest
    (_, _, _, _), (h2, _, k2, _, _) = host_route["mirrored"]
    assert 0 < k2.sum() < (h2 == np.arange(len(h2))).sum()


def test_contract_refuses_what_it_does_not_take():
    cn = torch.full((8,), -1, dtype=torch.int32)
    w = torch.zeros(4, dtype=torch.int64)
    for args in ((cn.long(), w, w, 47), (cn, w.int(), w, 47),
                 (cn, w, w[:3], 47), (cn[:6], w, w, 47), (cn, w, w, 0),
                 (cn, w, w, 64)):
        with pytest.raises(ValueError):
            contract_cuda.contract(*args)
    with pytest.raises(ValueError):  # K9's wrappers take no CPU tensor
        contract_cuda.contract_cuda(cn, w, w, 47)
    with pytest.raises(ValueError):
        contract_cuda.rank_cuda(cn)
    # a target shared by two nodes, a target out of range
    for bad in ([1, -1, 1, -1, -1, -1, -1, -1], [9, -1, -1, -1, -1, -1, -1,
                                                  -1]):
        t = torch.tensor(bad, dtype=torch.int32)
        assert contract_cuda.count_bad(t) == 1
        with pytest.raises(ValueError, match="out of range or shared"):
            contract_cuda.contract(t, w, w, 47)


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


def _finalize(hi, lo, real, counts, cn, params, is_seed, device, as_numpy):
    profiling.reset()
    h, l = bits.from_u64_np(hi, device), bits.from_u64_np(lo, device)
    c = torch.from_numpy(counts).to(device)
    chain = cn if as_numpy else torch.from_numpy(cn).to(device)
    out = contiger.finalize_unitigs(h, l, real, c, chain, params,
                                    is_seed=is_seed)
    return out, dict(profiling.GLOBAL.stats)


def _same_unitigs(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("k", [21, 47, 63])
def test_finalize_unitigs_host_route_for_numpy_and_cpu_inputs(k):
    args = _finalize_inputs(200 + k, k)
    before = contract_cuda.LAUNCHES
    a, sa = _finalize(*args, "cpu", as_numpy=True)
    b, sb = _finalize(*args, "cpu", as_numpy=False)
    assert contract_cuda.LAUNCHES == before
    _same_unitigs(a, b)
    assert a.n > 10
    for stats in (sa, sb):
        assert K9_SPAN not in stats
        for step in ("d2h", "walk", "revcomp", "keep rule"):
            assert stats[f"contiger:contract.{step}"].calls == 1


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
    chip_smoke.k9_compare(name, contract_cuda.contract_plain(*args, k), want)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [21, 47, 63])
def test_finalize_unitigs_cuda_matches_numpy_inputs(gpu, k):
    args = _finalize_inputs(300 + k, k)
    want, sw = _finalize(*args, "cpu", as_numpy=True)
    got, sg = _finalize(*args, gpu, as_numpy=False)
    _same_unitigs(got, want)
    assert sg[K9_SPAN].calls == 1 and K9_SPAN not in sw
    assert sg[K9_SPAN].parent == "contiger:contract.walk"
    for step in ("d2h", "walk", "revcomp", "keep rule"):
        assert sg[f"contiger:contract.{step}"].calls == 1


@pytest.mark.cuda
def test_k9_reports_a_malformed_forest(gpu):
    w = torch.zeros(4, dtype=torch.int64, device=gpu)
    for bad in ([1, -1, 1, -1, -1, -1, -1, -1], [9, -1, -1, -1, -1, -1, -1,
                                                  -1]):
        t = torch.tensor(bad, dtype=torch.int32, device=gpu)
        assert int(contract_cuda.contract(t, w, w, 47)[5].item()) == 1
