"""The port's last profiling entry points (``profile/{hot,collect,stage2,
entry}.py``) at a CPU size behind their arguments: what each counts
equals the JAX package's functions on the same inputs.  ``hot``: the sum
and count of the masked canonical hashes (``nthash.windowed_canonical``)
and K1's live entries; ``collect``: the node count of ``collect_nodes``;
``stage2``: the graph of ``build_oriented_graph`` on the same nodes and
spectrum; ``entry``: the buffer after the JAX ``entry()`` step on the same
arrays.  Tolerance: exact."""

import numpy as np
import pytest

import jax.numpy as jnp

from sh_assembly_tpu.io import fastq as jfastq
from sh_assembly_tpu.models import contiger as jcontiger
from sh_assembly_tpu.ops import nthash as jnthash
from sh_assembly_tpu.ops import packio as jpackio
from sh_assembly_tpu.ops import spectrum as jsp
from sh_assembly_tpu_torch.ops import bits, spectrum as sp
from sh_assembly_tpu_torch.profile import collect, entry, hot, kernels, \
    stage2

DEV = "cpu"  # the port's functions default to the GPU


def test_hot_counts_match_jax():
    rows, stacks, qb = 32, 2, 14
    assert hot.main(["--device", DEV, "--log2-capacity", str(qb),
                     "--log2-buf", "14", "--rows", str(rows), "--stacks",
                     str(stacks), "--reps", "1"]) == 0
    got = hot.LAST
    W = hot.L - hot.K + 1
    assert got["keys"] == got["appended"] == stacks * rows * W

    packed, nmask, lengths = hot.make_input(stacks, rows)
    total = valid_n = 0
    for s in range(stacks):
        codes = jpackio.unpack(jnp.asarray(packed[s]), jnp.asarray(nmask[s]),
                               hot.L)
        keys, valid = jnthash.windowed_canonical(codes, jnp.asarray(
            lengths[s]), hot.K)
        keys = np.asarray(keys)[np.asarray(valid)]
        total += int((keys & np.uint64((1 << (qb + 8)) - 1)).astype(
            object).sum())
        valid_n += keys.size
    assert valid_n == stacks * rows * W
    assert got["key_sum"] == total

    C = 1 << qb
    store, buf, n, kb, _ = kernels.big_case(DEV, n_live=C // 2, n_buf=1 << 14,
                                            key_bits=qb + 8, capacity=C)
    live = np.concatenate([bits.to_u64_np(store[:n]),
                           bits.to_u64_np(buf[buf != -1])])
    assert got["n_live"] == len(np.unique(live >> np.uint64(
        sp.payload_bits(kb))))


def test_collect_counts_match_jax():
    kw = dict(genome_len=6000, n_reads=1500, batch=256)
    assert collect.main(["--device", DEV, "--genome-len",
                         str(kw["genome_len"]), "--reads",
                         str(kw["n_reads"]), "--batch", str(kw["batch"])]) == 0
    got = collect.LAST
    assert "device_share" not in got  # no device on the CPU

    # profile_collect.py's own steps, in the JAX package
    kb = collect.QB + 8
    batches = [jfastq.Batch(codes=b.codes, lengths=b.lengths,
                            n_rows=b.n_rows)
               for b in collect.make_batches(**kw)]
    spec = jsp.make(1 << collect.QB, 1 << 21)
    W = collect.LR - collect.K + 1
    for b in batches:
        kk = jnthash.windowed_canonical(jnp.asarray(b.codes),
                                        jnp.asarray(b.lengths), collect.K)[0]
        valid = (jnp.arange(W)[None, :] + collect.K) <= \
            jnp.asarray(b.lengths)[:, None]
        kk = jnp.where(valid, kk & jnp.uint64((1 << kb) - 1), jsp.SENTINEL)
        spec = jsp.merge(jsp.insert(spec, kk.reshape(-1)), kb)
    hi, _, _ = jcontiger.collect_nodes(spec, iter(batches), collect.K, kb, 2)
    assert got["nodes"] == len(hi) > 1000


@pytest.mark.parametrize("log2_n", [10, 11])
def test_stage2_graph_matches_jax(log2_n):
    qb, log2_buf = 14, 12
    kb = qb + 8
    assert stage2.main(["--device", DEV, "--log2-n", str(log2_n),
                        "--log2-capacity", str(qb), "--log2-buf",
                        str(log2_buf)]) == 0
    got = stage2.LAST

    hp, lp = stage2.node_kmers(log2_n)
    spec = stage2.build_spectrum(bits.from_u64_np(hp, DEV),
                                 bits.from_u64_np(lp, DEV), kb, 1 << qb,
                                 1 << log2_buf)
    assert spec.ndistinct == got["distinct"] >= (1 << qb) // 2
    keys, counts, trav = sp.to_host(spec, kb)
    jspec = jsp.from_host(keys, counts, 1 << qb, 1 << 10, kb, traveled=trav)
    nsucc, chain_next, _ = jcontiger.build_oriented_graph(
        jspec, jnp.asarray(hp), jnp.asarray(lp), stage2.K, kb, 2)
    assert got["succ_edges"] == int(np.asarray(nsucc).astype(np.int64).sum())
    assert got["chain_edges"] == int((np.asarray(chain_next) >= 0).sum())
    assert got["chain_edges"] > (1 << log2_n) // 2


def test_entry_step_matches_jax():
    import __graft_entry__

    jfn, (jspec, jcodes, jlengths) = __graft_entry__.entry()
    fn, (spec, codes, lengths) = entry.entry(DEV)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(jlengths))
    jout, out = jfn(jspec, jcodes, jlengths), fn(spec, codes, lengths)
    planes = sp.to_jax_planes(out)
    assert planes["n_buf"] == int(jout.n_buf) == entry.B * (
        entry.L - entry.K + 1)
    for f in ("buf_hi", "buf_lo"):
        np.testing.assert_array_equal(planes[f], np.asarray(getattr(jout, f)))
    assert entry.main(["--device", DEV]) == 0
