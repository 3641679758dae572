"""The port's Contiger stages against the JAX package's, bitwise, on the
CPU: node collection (K2's and K3's plain versions behind the flushes),
the phantom closure (including a round whose output is truncated to the
frontier extent), the oriented graph probes, and the pointer-jumping
contraction against the host C++ walk."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sh_assembly_tpu import config as jcfg
from sh_assembly_tpu.io import fastq as jfastq
from sh_assembly_tpu.models import contiger as jcontiger
from sh_assembly_tpu.models import counter as jcounter
from sh_assembly_tpu.ops import spectrum as jsp
from sh_assembly_tpu_torch.io import fastq
from sh_assembly_tpu_torch.models import contiger
from sh_assembly_tpu_torch.ops import bits, kmerpack_np
from sh_assembly_tpu_torch.ops import spectrum as sp

DEV = "cpu"  # the port's functions default to the GPU

KEY_BITS = 22  # dense enough for phantom nodes at this genome size


def _reads(seed: int, n=700, length=130, genome_len=4000):
    """Reads from both strands of a random genome, 1% substitutions."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=genome_len).astype(np.uint8)
    reads = []
    for _ in range(n):
        s = int(rng.integers(0, genome_len - length))
        r = genome[s:s + length].copy()
        if rng.random() < 0.5:
            r = (3 - r)[::-1].copy()
        err = rng.random(length) < 0.01
        r[err] = (r[err] + 1) % 4
        reads.append(r)
    return reads


def _batches(batcher_mod, reads, k, rows=64, L=136):
    b = batcher_mod.Batcher(k, rows, L)
    return [x for r in reads for x in b.add_read(r)] + list(b.flush())


def _spectra(reads, k):
    """The JAX package's spectrum of the reads, and the same state as the
    port's Spectrum."""
    sizing = jcfg.CounterSizing(
        k=k, qb=14, hb=KEY_BITS, num_true_kmers=0, num_false_kmers=0,
        n_true_kmers=1, num_deNoise=0, ndistinct_for_deNoise=1 << 62,
        end_deNoise=False, fr=0.0)
    jspec, _ = jcounter.build_spectrum(
        iter(_batches(jfastq, reads, k)), sizing, capacity=1 << 16,
        buf_capacity=1 << 14,
        batch_cfg=jcfg.BatchConfig(reads_per_batch=64, max_read_len=136))
    spec = sp.from_jax_planes(
        hi=np.asarray(jspec.hi), lo=np.asarray(jspec.lo),
        buf_hi=np.asarray(jspec.buf_hi), buf_lo=np.asarray(jspec.buf_lo),
        n_main=int(jspec.n_main), n_buf=int(jspec.n_buf),
        ndistinct=int(jspec.ndistinct), nelts=int(jspec.nelts), device=DEV)
    return jspec, spec


def _eq64(got: torch.Tensor, ref) -> None:
    np.testing.assert_array_equal(bits.to_u64_np(got), np.asarray(ref))


@pytest.mark.parametrize("k,super_batch,pend_supers", [
    (21, 2, 1),   # a flush every two batches
    (47, 8, 8),   # the defaults: one flush at the end
    (63, 2, 1),   # the widest k: no free low bits in lo
])
def test_stages_match_jax(k, super_batch, pend_supers):
    reads = _reads(k)
    jspec, spec = _spectra(reads, k)
    amin = 2

    # A: node collection
    jhi, jlo, jseed = jcontiger.collect_nodes(
        jspec, iter(_batches(jfastq, reads, k)), k, KEY_BITS, amin,
        super_batch=super_batch, pend_supers=pend_supers)
    hi, lo, seed = contiger.collect_nodes(
        spec, iter(_batches(fastq, reads, k)), k, KEY_BITS, amin,
        super_batch=super_batch, pend_supers=pend_supers)
    assert len(jhi) > 1000
    _eq64(hi, jhi)
    _eq64(lo, jlo)
    np.testing.assert_array_equal(seed.numpy(), jseed)
    assert 0 < int(seed.sum()) < len(jhi)

    # B: phantom closure
    jhi, jlo, jn = jcontiger.close_over_phantoms(jspec, jhi, jlo, k,
                                                 KEY_BITS, amin)
    hi, lo, n = contiger.close_over_phantoms(spec, hi, lo, k, KEY_BITS, amin)
    assert n == jn > 0
    _eq64(hi, jhi)
    _eq64(lo, jlo)

    # C: graph probes over the padded node set
    N = len(jhi)
    Np = 1 << max(int(np.ceil(np.log2(max(N, 1024)))), 10)
    pad_hi = np.full(Np, contiger.NODE_SENTINEL)
    pad_lo = np.full(Np, contiger.NODE_SENTINEL)
    pad_hi[:N], pad_lo[:N] = jhi, jlo
    ref = jcontiger.build_oriented_graph(
        jspec, jnp.asarray(pad_hi), jnp.asarray(pad_lo), k, KEY_BITS, amin)
    got = contiger.build_oriented_graph(
        spec, bits.from_u64_np(pad_hi, DEV), bits.from_u64_np(pad_lo, DEV), k,
        KEY_BITS, amin)
    for g, r, name in zip(got, ref, ("nsucc", "chain_next", "node_counts")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), name)
    assert int((got[1] >= 0).sum()) > N


def test_phantom_closure_with_a_truncated_round():
    """A dense hash space (a quarter of all keys counted) around 900 random
    7-mers: round 1 finds more phantoms than the padded frontier holds, so
    its output is truncated and round 2 re-probes the whole store."""
    k, key_bits = 7, 20
    rng = np.random.default_rng(0)
    n = 1 << (key_bits - 2)
    keys = np.sort(rng.choice(1 << key_bits, n, replace=False)
                   .astype(np.uint64))
    counts = np.full(n, 5, np.int64)
    jspec = jsp.from_host(keys, counts, n, 1024, key_bits)
    spec = sp.from_host(keys, counts, n, 1024, key_bits, device=DEV)
    v = rng.choice(1 << (2 * k), 900, replace=False).astype(np.uint64) \
        << np.uint64(64 - 2 * k)
    rv, _ = kmerpack_np.revcomp_packed(v, np.zeros_like(v), k)
    hi0 = np.unique(np.minimum(v, rv))
    lo0 = np.zeros_like(hi0)

    found = []
    real = contiger.phantom_candidates

    def spy(*args, **kw):
        out = real(*args, **kw)
        found.append((args[3].shape[0], out[2], out[3]))
        return out

    contiger.phantom_candidates = spy
    try:
        hi, lo, n_ph = contiger.close_over_phantoms(
            spec, bits.from_u64_np(hi0, DEV), bits.from_u64_np(lo0, DEV), k,
            key_bits, 1)
    finally:
        contiger.phantom_candidates = real
    jhi, jlo, jn = jcontiger.close_over_phantoms(jspec, hi0, lo0, k,
                                                 key_bits, 1)
    F, n_new, n_found = found[0]
    assert n_found > n_new == F  # round 1 was truncated
    assert len(found) > 2
    assert n_ph == jn
    _eq64(hi, jhi)
    _eq64(lo, jlo)


def test_collect_nodes_overflow_raises_like_jax():
    k = 31
    reads = _reads(5)
    jspec, spec = _spectra(reads, k)
    with pytest.raises(RuntimeError, match="node store overflow"):
        jcontiger.collect_nodes(jspec, iter(_batches(jfastq, reads, k)), k,
                                KEY_BITS, 2, node_cap=1024)
    with pytest.raises(RuntimeError, match="node store overflow"):
        contiger.collect_nodes(spec, iter(_batches(fastq, reads, k)), k,
                               KEY_BITS, 2, node_cap=1024)


def test_contract_paths_matches_host_walk():
    """The pointer-jumping contraction against the native C++ walk
    (cpp/contract.cpp) on disjoint chains and cycles."""
    rng = np.random.default_rng(7)
    M = 4096
    nxt = np.full(M, -1, np.int32)
    perm = rng.permutation(M)
    i = 0
    while i < M - 64:
        ln = int(rng.integers(1, 17))
        chain = perm[i:i + ln]
        nxt[chain[:-1]] = chain[1:]
        i += ln
    tail = perm[i:]
    for c0 in range(0, len(tail) - 6, 6):
        cyc = tail[c0:c0 + 6]
        nxt[cyc] = np.roll(cyc, -1)
    hh, dh, th = contiger.contract_paths_host(nxt)
    hd, dd, td = contiger.contract_paths(torch.from_numpy(nxt))
    assert (hh != np.arange(M)).any() and th.any()
    np.testing.assert_array_equal(hd.numpy(), hh)
    np.testing.assert_array_equal(dd.numpy(), dh)
    np.testing.assert_array_equal(td.numpy(), th.astype(bool))
    jh, jd, jt = jcontiger.contract_paths(jnp.asarray(nxt))
    np.testing.assert_array_equal(hd.numpy(), np.asarray(jh))
