"""Time the Contiger's device passes at the counting state of a large
genome: the graph probes and the contraction, in nodes/s.

    python -m sh_assembly_tpu_torch.profile.stage2 [--device cuda]

Counterpart of ``profile_stage2_flagship.py``: k = 47, qb = 28 (C = 2^28
slots, key_bits 36), a buffer of 2^26 slots, N = 2^24 node k-mers taken as
the consecutive windows of a random genome (``np.random.default_rng(7)``),
so that successor probes hit and chains contract.  The spectrum holds
every node's key twice (the abundance filter passes) and random keys up
to half its slots.  Times ``contiger.build_oriented_graph`` (the 8 + 1
probes a node: kernels K8 and K7 and the K2 count join on the card) and
the contraction where the forest lies (``contract_cuda.contract``: kernel
K9's ranking, reverse complements and keep rule on the card, through to a
synchronise), the second of two runs each, and logs their rates and the K7
and K8 launches of the timed run.

It does not carry the script's two faults (ROADMAP §3, fault 8): its
default is N = 2^24, at which the script's constants were taken (it
defaults to 2^25, which its own record says aborts), and its random filler
merges after every insert (the script inserts two buffer-sized chunks
before merging, so the second overwrites the first).  ``--log2-n``,
``--log2-capacity`` and ``--log2-buf`` cut the size for a CPU run, whose
times mean nothing.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..cli.cqf_denoise import resolve_device
from ..models import contiger
from ..ops import bits, contract_cuda, node_join_cuda, probe_cuda, \
    spectrum as sp
from ..utils.logging import log

# The numbers of the last run() in this process, for callers of main().
LAST: dict = {}

K = 47


def node_kmers(log2_n: int, k: int = K):
    """2^log2_n consecutive k-mers of a random genome (seed 7), packed
    MSB-first and left-aligned at bit 127 -> (hi, lo) numpy uint64."""
    n = 1 << log2_n
    genome = np.random.default_rng(7).integers(0, 4, size=n + k).astype(
        np.uint64)
    hi = np.zeros(n, np.uint64)
    lo = np.zeros(n, np.uint64)
    for j in range(k):
        shift = 126 - 2 * j
        col = genome[j:j + n]
        if shift >= 64:
            hi |= col << np.uint64(shift - 64)
        else:
            lo |= col << np.uint64(shift)
    return hi, lo


def build_spectrum(hi: torch.Tensor, lo: torch.Tensor, key_bits: int,
                   capacity: int, buf_capacity: int,
                   k: int = K) -> sp.Spectrum:
    """Every node's key inserted twice, then random keys (a device
    generator, seed 7) until half the slots hold distinct keys; a merge
    after every buffer-sized insert."""
    device = hi.device
    fh, rh = probe_cuda.node_hashes(hi, lo, k)
    keys = bits.umin(fh, rh) & ((1 << key_bits) - 1)
    del fh, rh
    spec = sp.make(capacity, buf_capacity, device)
    for _ in range(2):
        for i in range(0, keys.numel(), buf_capacity):
            spec = sp.merge(sp.insert(spec, keys[i:i + buf_capacity]),
                            key_bits)
    del keys
    g = torch.Generator(device=device).manual_seed(7)
    while spec.ndistinct < capacity // 2:
        spec = sp.merge(sp.insert(spec, torch.randint(
            0, 1 << key_bits, (buf_capacity,), generator=g, device=device)),
            key_bits)
    return sp.drop_spare(spec)


def run(device, log2_n: int = 24, log2_capacity: int = 28,
        log2_buf: int = 26) -> dict:
    key_bits = log2_capacity + 8
    N = 1 << log2_n
    t_all = time.time()
    hp, lp = node_kmers(log2_n)
    hi, lo = bits.from_u64_np(hp, device), bits.from_u64_np(lp, device)
    del hp, lp
    spec = build_spectrum(hi, lo, key_bits, 1 << log2_capacity,
                          1 << log2_buf)
    log(f"spectrum: {spec.ndistinct} distinct keys at load "
        f"{spec.ndistinct / spec.capacity:.2f}, {N} nodes "
        f"({time.time() - t_all:.0f} s)")

    def once():
        t0 = time.time()
        nsucc, chain_next, _ = contiger.build_oriented_graph(
            spec, hi, lo, K, key_bits, 2)
        cn = chain_next.cpu().numpy()  # synchronises
        t_probe = time.time() - t0
        t0 = time.time()
        contract_cuda.contract(chain_next, hi, lo, K)  # where it lies
        if chain_next.is_cuda:
            torch.cuda.synchronize(chain_next.device)
        return t_probe, time.time() - t0, cn, int(nsucc.long().sum())

    once()  # warm-up
    launches = (probe_cuda.LAUNCHES, node_join_cuda.LAUNCHES)
    t_probe, t_contract, cn, n_succ = once()
    k8, k7 = (a - b for a, b in zip(
        (probe_cuda.LAUNCHES, node_join_cuda.LAUNCHES), launches))
    res = dict(nodes=N, distinct=spec.ndistinct,
               chain_edges=int((cn >= 0).sum()), succ_edges=n_succ,
               probe_s=t_probe, contract_s=t_contract,
               probe_nodes_per_s=N / t_probe,
               contract_nodes_per_s=N / t_contract,
               node_probes_launches=k8, node_join_launches=k7)
    log(f"probe (build_oriented_graph): {t_probe:.3f} s = "
        f"{N / t_probe / 1e6:.2f} M nodes/s (K8 node_probes {k8} and K7 "
        f"node_join {k7} launches)")
    log(f"contract (the ranking, reverse complements and keep rule where "
        f"the forest lies): {t_contract:.3f} s = "
        f"{N / t_contract / 1e6:.2f} M nodes/s ({res['chain_edges']} chain "
        f"edges, {n_succ} successor edges)")
    log(f"total {time.time() - t_all:.0f} s")
    return res


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="profile.stage2")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--log2-n", type=int, default=24)
    p.add_argument("--log2-capacity", type=int, default=28)
    p.add_argument("--log2-buf", type=int, default=26)
    args = p.parse_args(argv)
    LAST.clear()
    LAST.update(run(resolve_device(args.device), args.log2_n,
                    args.log2_capacity, args.log2_buf))
    return 0


if __name__ == "__main__":
    sys.exit(main())
