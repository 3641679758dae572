"""Kernel K10, the members of the kept paths placed by (head, dist)
(``ops/members_cuda``), and its plain twin, bitwise.

On the CPU ``members`` takes the plain twin (``members_plain``, fed by K9's
plain twins), held against the JAX package's members step (the first
lines of its ``_finalize_host``: mask, lexsort, gathers; ``jax_members``
below is that step, the reference, on the JAX package's contraction) on
``chip_smoke.k10_cases``: paths, cycles not starting at their least node,
padding rows, a mirrored forest with palindromic heads that keep both
mirrors, cycles only, a store of padding rows alone (no member:
``ArrayUnitigs.empty``) and M = 2, each at k = 21, 31, 47 and 63; a forged
forest raises; ``finalize_unitigs`` on CPU tensors gives the JAX package's
unitigs.  Marked ``cuda`` (skipped without a GPU): K10 against the plain
twin on the CPU and on the card, also at the E. coli cell's 2^24 oriented
nodes; ``finalize_unitigs`` from CUDA tensors against CPU tensors, with one
placement; K10's refusals.  The card has no JAX, so there the tests that
read it skip, and the rest run with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_members.py
"""

import numpy as np
import pytest
import torch

import chip_smoke
from sh_assembly_tpu_torch.ops import members_cuda

from test_torch_contract import _finalize, _finalize_inputs, \
    _same_unitigs, jax_finalize, jax_k9

CASES = {c[0]: c[1:] for c in chip_smoke.k10_cases()}
CPU = torch.device("cpu")
MEMBERS = "contiger:host assembly.members"


def jax_members(cn, hi, lo, real, counts, k):
    """The reference: the JAX package's members step (``_finalize_host``,
    up to its mirror dedup) on its own contraction (``jax_k9``) ->
    ``chip_smoke.K10Members``, or None where no kept path has a member."""
    head, dist, _, keep, rhi, rlo = jax_k9(cn, hi, lo, k)
    from sh_assembly_tpu.ops import kmerpack_np as jkpn

    a = np.arange(2 * len(hi), dtype=np.int64)
    member = keep[head] & real[a >> 1]  # drop sentinel padding nodes
    heads = head[member].astype(np.int64)
    if len(heads) == 0:
        return None
    ai = a[member]
    order = np.lexsort((dist[member], heads))
    heads, ai = heads[order], ai[order]
    node_i, orient = ai >> 1, ai & 1
    ohi = np.where(orient == 0, hi[node_i], rhi[node_i])
    olo = np.where(orient == 0, lo[node_i], rlo[node_i])
    starts = np.flatnonzero(
        np.r_[True, heads[1:] != heads[:-1]]).astype(np.int64)
    lens = np.diff(np.r_[starts, len(heads)])
    return chip_smoke.K10Members(ai, node_i, ohi, olo,
                                 jkpn.last_base(ohi, olo, k),
                                 counts.astype(np.int64)[node_i], starts,
                                 lens, starts + lens - 1, heads[starts])


@pytest.fixture(scope="module")
def host_step():
    """Each case's members by the JAX package's step."""
    return {name: jax_members(*case) for name, case in CASES.items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_members_plain_matches_host_step(host_step, name):
    args = chip_smoke.k10_inputs(*CASES[name], CPU)
    before = members_cuda.LAUNCHES
    got = members_cuda.members(*args, CASES[name][-1])
    assert members_cuda.LAUNCHES == before  # CPU tensors take the twin
    chip_smoke.k10_compare(name, got, host_step[name])


def test_cases_hold_what_they_promise(host_step):
    """Palindromic heads keep both mirrors, the store of padding rows keeps
    heads and has no member, and the mixed forest holds cycles cut off
    their head and padding rows."""
    for k in (21, 31, 47, 63):
        cn, hi, lo, real, counts, _ = CASES[f"mirrored_k{k}"]
        _, _, tail_of, keep, _, _ = jax_k9(cn, hi, lo, k)
        kept = np.flatnonzero(keep)
        assert (keep[tail_of[kept] ^ 1]).sum() >= 40
        m = host_step[f"mirrored_k{k}"]
        assert len(m.ai) > real.sum()  # both mirrors of a palindrome
        cn, hi, lo, real, _, _ = CASES[f"no_member_k{k}"]
        assert not real.any() and jax_k9(cn, hi, lo, k)[3].any()
        assert host_step[f"no_member_k{k}"] is None
        cn, hi, lo, real, _, _ = CASES[f"mixed_k{k}"]
        head, dist, *_ = jax_k9(cn, hi, lo, k)
        has_prev = np.zeros(len(cn), bool)
        has_prev[cn[cn >= 0]] = True
        assert (dist[has_prev[head]] > 0).any() and (~real).sum() > 300


def _forged(case, how):
    """A case's K10 inputs on the CPU with a padding row inside a kept path,
    or a kept head's tail_of pointing one step short of its path's end."""
    cn, hi, lo, real, counts, k = case
    args = list(chip_smoke.k10_inputs(cn, hi, lo, real, counts, k, CPU))
    head, dist, tail_of, keep = args[:4]
    a = torch.nonzero(keep[head.long()] & (dist > 0)).squeeze(1)[0]
    h = int(head[a])
    if how == "padding_row":
        real = args[8].clone()
        real[int(a) >> 1] = False
        args[8] = real
    else:
        t = int(tail_of[h])
        prev = torch.nonzero(torch.from_numpy(cn) == t).squeeze(1)
        tail_of = tail_of.clone()
        tail_of[h] = int(prev[0])
        args[2] = tail_of
    return args, k


@pytest.mark.parametrize("how", ["padding_row", "short_tail"])
def test_members_refuse_a_forged_forest(how):
    args, k = _forged(CASES["mirrored_k47"], how)
    with pytest.raises(ValueError, match="K10 placed .* members"):
        members_cuda.members(*args, k)


def test_members_refuse_what_they_do_not_take():
    args = list(chip_smoke.k10_inputs(*CASES["mixed_k47"][:-1], 47, CPU))
    for i, bad in ((0, args[0].long()), (3, args[3].int()),
                   (8, args[8][:-1]), (9, args[9].long()), (4, args[4][:-2])):
        with pytest.raises(ValueError):
            members_cuda.members(*(args[:i] + [bad] + args[i + 1:]), 47)
    for k in (0, 64):
        with pytest.raises(ValueError):
            members_cuda.members(*args, k)
    with pytest.raises(ValueError):  # K10's wrapper takes no CPU tensor
        members_cuda.members_cuda(*args, 47)


@pytest.mark.parametrize("k", [21, 31, 47, 63])
def test_finalize_unitigs_host_route_takes_no_k10(k):
    """CPU tensors take the plain twin (no placement), open the members
    span once, and give the JAX package's unitigs on the same forest."""
    args = _finalize_inputs(400 + k, k)
    before = members_cuda.LAUNCHES
    out, stats = _finalize(*args, "cpu")
    assert out.n > 10
    assert stats[MEMBERS].calls == 1
    assert stats[MEMBERS].parent == "contiger:host assembly"
    assert members_cuda.LAUNCHES == before
    _same_unitigs(out, jax_finalize(*args))


# --------------------------------------------------------------------------
# On the card

@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES) + ["cell_extent"])
def test_k10_matches_plain_and_host_step(gpu, name):
    """K10 on the card against the plain twin on the CPU (``k10_host``) and
    on the card."""
    if name == "cell_extent":
        case = next(c for c in chip_smoke.k10_cases(large=True)
                    if c[0] == name)[1:]
    else:
        case = CASES[name]
    want = chip_smoke.k10_host(*case)
    args = chip_smoke.k10_inputs(*case, gpu)
    before = members_cuda.LAUNCHES
    got = members_cuda.members(*args, case[-1])
    assert members_cuda.LAUNCHES == before + 1
    chip_smoke.k10_compare(name, got, want)
    chip_smoke.k10_compare(name, members_cuda.members_plain(*args, case[-1]),
                           want)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [21, 47, 63])
def test_finalize_unitigs_cuda_k10_matches_numpy_inputs(gpu, k, tmp_path):
    """CUDA tensors take K10 (one placement) and give the CPU tensors' (the
    plain twins') unitigs and unitigs.fa, the members span opened once."""
    args = _finalize_inputs(500 + k, k)
    want, _ = _finalize(*args, "cpu")
    before = members_cuda.LAUNCHES
    got, sg = _finalize(*args, gpu)
    assert members_cuda.LAUNCHES == before + 1
    _same_unitigs(got, want)
    files = []
    for name, u in (("cuda", got), ("cpu", want)):
        files.append(tmp_path / f"{name}.fa")
        u.write_fasta(str(files[-1]))
    assert files[0].read_bytes() == files[1].read_bytes()
    assert sg[MEMBERS].calls == 1


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["padding_row", "short_tail"])
def test_k10_refuses_a_forged_forest(gpu, how):
    args, k = _forged(CASES["mirrored_k47"], how)
    args = [t.to(gpu) for t in args]
    with pytest.raises(ValueError, match="K10 placed .* members"):
        members_cuda.members(*args, k)
