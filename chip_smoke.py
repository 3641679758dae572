#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sh_assembly_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits non-zero without printing a result:

  0. device: nvidia-smi name and power limit, torch/CUDA versions; no GPU
     is an error.
  1. build: compiles kernels K1-K4 (csrc/merge_dedup.cu, count_join.cu,
     merge128.cu, block_sort.cu) from the checkout, one nvcc each, in
     parallel.
  2. K1 against its plain PyTorch twin on the card, bitwise: the merge
     cases of the JAX package's kernel tests, the maximum key, counts at
     the cap, empty inputs, runs spanning many tiles, an overflowing
     merge, and one merge and one sweep at the counting stage's real
     size (~100 M live entries, a full 2^27 buffer, key_bits 37, 2^29
     slots), timed against the twin.
  3. parity: the CQF-deNoise CLI on one synthetic FASTQ with --device cpu
     and --device cuda, with deNoise sweeps firing mid-stream; the two
     .ser files must be byte-identical.
  4. main path at real state size: the CLI with the C. elegans flags of
     the reference README (2^29-slot store, 2^27-slot buffer) on 3 M
     synthetic reads; counts K1 launches, checks the .ser header, reports
     k-mers/s and peak device memory.
  5. K2 (count join) and K3 (node-store fold) against their plain PyTorch
     versions on the card, bitwise: the cases of the JAX package's kernel
     tests, empty and all-matching inputs, the maximum key, traveled
     entries, sentinels, k = 62 poly-T k-mers, an overflowing fold, and
     one call each at the main path's real shape (9 x 2^24 probes against
     phase 2's 100 M-entry store; a 12 M-entry node store against 2^22
     survivors), timed against the plain versions.
  6. parity: the pipeline CLI (reads -> unitigs -> contigs) on the bench's
     end-to-end shape with --device cpu and --device cuda; unitigs.fa and
     contigs.fa must be byte-identical and the CUDA run must launch K1,
     K2 and K3; then the Contiger CLI with --device cuda on the CPU run's
     .ser, whose unitigs.fa must equal the CPU pipeline's and which must
     launch K2 and K3.
  7. main path at real size: the pipeline CLI on a 12 Mbp genome (30x of
     150 bp reads); prints the phase breakdown, peak device memory, node,
     unitig and contig counts and N50; the contigs must total within 10%
     of the genome, every kernel must launch, and the native contraction
     library must load.

  8. K4 (window sort) against its plain PyTorch version on the card,
     bitwise: windows of 2^7 to 2^17 values, several each, with random
     values over the whole u32 range, all equal, sorted, reversed and only
     0 and 0xFFFFFFFF; then the profiling entry point
     (profile.blocksort.main) at its real shape, 2^27 values in windows of
     2^17, timed against the plain torch.sort rows, and the buffer-sort
     yardsticks of profile.sort.main (variants A-H at 2^27 keys).
  9. the library surface off the main path on the card: union, intersect,
     inner_product, magnitude, query_set_traveled and query_is_traveled on
     two spectra of 50 M live keys each in 2^27 slots; a cut of the same
     keys through the CPU and the card, which must agree bitwise
     (magnitude to 1e-9 relative: its float64 sum is taken in another
     order); inner_product and intersect must launch K2.  Then the tools
     on phase 6's files: cli.minia on the CUDA run's unitigs.fa, whose
     contigs cli.compare_contigs must find equal to the pipeline's as a
     set of sequences, the CPU and CUDA contigs equal, and cli.cqf_dump
     --meta-only printing the .ser header.

The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels: launches on the path that runs each (phase 7 for K1-K3,
phase 8's profiling entry point for K4, which the main path never
launches), times, and each kernel's bound, the least time the card could
take, computed from this run's shapes and results: the larger of the
bytes moved (each input read once, the live result written once) over
HBM_BYTES_PER_S and the key comparisons over OPS_PER_S.  Work files go to
build/chip_smoke/ (ignored by git) and are removed at the end.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
HBM_BYTES_PER_S = 3.35e12  # published peak of one H100 SXM
OPS_PER_S = 67e12  # its published 32-bit rate outside the tensor cores


def bound_ms(n_bytes: int) -> float:
    """The least time the card could take to move n_bytes."""
    return n_bytes / HBM_BYTES_PER_S * 1e3


def bound(n_bytes: int, n_ops: int) -> dict:
    """A kernel's bound: the larger of its bytes over the memory rate and
    its operations (here: key comparisons) over the 32-bit rate."""
    by_bytes, by_ops = bound_ms(n_bytes), n_ops / OPS_PER_S * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


# ---------------------------------------------------------------------------
# Inputs (numpy seeds)

_ASCII = np.frombuffer(b"ACGTN", np.uint8)


def write_fastq(path: str, genome_len: int, n_reads: int, read_len: int,
                sub_rate: float, n_rate: float, seed: int) -> None:
    """Reads sampled from both strands of a random genome, with
    substitutions and occasional Ns, written as FASTQ in bulk."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=genome_len, dtype=np.uint8)
    with open(path, "wb") as f:
        chunk = 1 << 18
        for c0 in range(0, n_reads, chunk):
            m = min(chunk, n_reads - c0)
            starts = rng.integers(0, genome_len - read_len + 1, size=m)
            reads = genome[starts[:, None] + np.arange(read_len)]
            rc = rng.random(m) < 0.5
            reads[rc] = 3 - reads[rc, ::-1]
            err = rng.random(reads.shape) < sub_rate
            shift = rng.integers(1, 4, size=reads.shape, dtype=np.uint8)
            reads = np.where(err, (reads + shift) % 4, reads)
            reads = np.where(rng.random(reads.shape) < n_rate, 4, reads)
            seq = _ASCII[reads]
            ids = np.char.add(b"@r", np.arange(c0, c0 + m).astype("S12"))
            nl = np.full((m, 1), ord("\n"), np.uint8)
            qual = np.full((m, read_len), ord("I"), np.uint8)
            plus = np.tile(np.frombuffer(b"\n+\n", np.uint8), (m, 1))
            body = np.concatenate([nl, seq, plus, qual, nl], axis=1)
            for i in range(m):
                f.write(ids[i])
                f.write(body[i].tobytes())
    with open(os.path.join(os.path.dirname(path), "ReadFiles.txt"), "w") as f:
        f.write(os.path.basename(path) + "\n")


def k1_cases(device):
    """(name, main, buf, n_main, key_bits, drop, capacity) tuples for K1:
    a key-sorted main store and a sorted count-0 buffer, made from numpy
    seeds through the port's own store functions."""
    import torch

    from sh_assembly_tpu_torch.ops import spectrum as sp

    def state(seed, key_bits, C_real, BC_real, hot, out_cap=None):
        rng = np.random.default_rng(seed)
        mk = np.unique(rng.integers(0, 1 << key_bits, size=max(C_real, 1),
                                    dtype=np.uint64))[:C_real]
        mc = rng.integers(1, 100, size=len(mk))
        mt = rng.integers(0, 2, size=len(mk)).astype(np.uint8)
        n_buf = int(rng.integers(0, BC_real, endpoint=True)) if BC_real else 0
        pool = np.concatenate([mk, rng.integers(
            0, 1 << key_bits, size=max(8, n_buf), dtype=np.uint64)])
        bk = rng.choice(pool, size=n_buf) if n_buf else np.empty(0, np.uint64)
        if hot and n_buf > 10:
            bk[: n_buf // 2] = pool[0]
        holes = np.full(max(BC_real, 1), 0xFFFFFFFFFFFFFFFF, np.uint64)
        if n_buf:
            holes[rng.choice(len(holes), size=n_buf, replace=False)] = bk
        C = out_cap or len(mk) + n_buf
        s = sp.from_host(mk, mc, max(C, len(mk), 1), len(holes), key_bits,
                         traveled=mt, device=device)
        s = sp.insert(s, torch.from_numpy(holes.view(np.int64)).to(device))
        return s, C

    def max_key(key_bits, count):
        kmax = (1 << key_bits) - 1
        mk = np.array([0, 12345, kmax], np.uint64)
        bk = np.concatenate([np.full(3000, kmax, np.uint64),
                             np.array([7, 8, 12345, 0], np.uint64),
                             np.full(40, 0xFFFFFFFFFFFFFFFF, np.uint64)])
        np.random.default_rng(key_bits).shuffle(bk)
        s = sp.from_host(mk, np.array([1, count, count]), 64, len(bk),
                         key_bits, traveled=np.array([1, 0, 1], np.uint8),
                         device=device)
        return sp.insert(s, torch.from_numpy(bk.view(np.int64)).to(device)), 64

    specs = []
    # the cases of tests/test_merge_pallas.py
    for seed, kb, C_real, BC_real, drop, hot in [
            (0, 33, 500, 1500, False, False), (1, 33, 500, 1500, True, False),
            (2, 24, 300, 2000, False, False), (3, 24, 300, 2000, True, True),
            (4, 40, 900, 3000, False, True), (5, 48, 10, 50, False, False),
            (6, 33, 0, 1000, False, False), (7, 33, 800, 0, True, False),
            (8, 20, 100, 700, False, False)]:
        s, C = state(seed, kb, C_real, BC_real, hot)
        specs.append((f"case{seed}_kb{kb}", s, kb, drop, C))
    for kb, drop in ((33, False), (40, True), (56, False), (56, True)):
        s, C = max_key(kb, sp.count_cap(kb) - 1)
        specs.append((f"maxkey_cap_kb{kb}_drop{int(drop)}", s, kb, drop, C))
    # many tiles, a hot key spanning several of them, sweeps on and off
    for seed, drop in ((21, False), (22, True)):
        s, C = state(seed, 37, 200_000, 300_000, True)
        specs.append((f"tiles_hot_drop{int(drop)}", s, 37, drop, C))
    # more survivors than the output holds: n_live reports the true count
    s, C = state(23, 30, 5000, 8000, False, out_cap=6000)
    specs.append(("overflow", s, 30, False, C))

    for name, s, kb, drop, C in specs:
        buf = sp.sort_pack_buf(s.buf[:s.n_buf], kb)
        yield name, s.store, buf, s.n_main, kb, drop, C
        if not drop and name.startswith("case"):
            # the sweep of the same store: K1 with an empty buffer
            yield name + "_sweep", s.store, buf[:0], s.n_main, kb, True, C


_SENT64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def k2_cases(device):
    """(name, store, n_main, queries, key_bits) tuples for K2: a merged
    spectrum store and ascending raw query keys with a sentinel tail, made
    from numpy seeds through the port's own store functions."""
    from sh_assembly_tpu_torch.ops import bits
    from sh_assembly_tpu_torch.ops import spectrum as sp

    def spectrum(keys, counts, trav, key_bits, capacity=None):
        C = capacity or 1 << int(np.ceil(np.log2(len(keys) + 1)))
        return sp.from_host(keys, counts, C, 1 << 10, key_bits,
                            traveled=trav, device=device)

    def case(seed, key_bits, n_spec, n_q, present=0.5, n_sent=37):
        rng = np.random.default_rng(seed)
        keys = np.unique(rng.integers(0, 1 << key_bits, size=n_spec,
                                      dtype=np.uint64))
        counts = rng.integers(1, 200, size=len(keys))
        trav = (rng.random(len(keys)) < 0.4).astype(np.uint8)
        n_p = int(n_q * present)
        q = np.sort(np.concatenate([
            rng.choice(keys, size=n_p),
            rng.integers(0, 1 << key_bits, size=n_q - n_p, dtype=np.uint64)]))
        q = np.concatenate([q, np.full(n_sent, _SENT64)])
        s = spectrum(keys, counts, trav, key_bits)
        return s.store, s.n_main, bits.from_u64_np(q, device), key_bits

    # the cases of tests/test_join_pallas.py
    for i, (kb, n_spec, n_q) in enumerate([(22, 700, 900), (22, 2000, 300),
                                           (36, 1500, 1500)]):
        yield (f"join{i}_kb{kb}", *case(i, kb, n_spec, n_q))
    yield ("all_match", *case(3, 30, 5000, 20000, present=1.0, n_sent=0))
    # many blocks, each bounding its own key range of the store
    yield ("blocks_kb37", *case(4, 37, 200_000, 300_000))
    rng = np.random.default_rng(5)
    q = np.concatenate([np.sort(rng.integers(0, 1 << 30, size=3000,
                                             dtype=np.uint64)),
                        np.full(100, _SENT64)])
    empty = spectrum(np.zeros(0, np.uint64), np.zeros(0, np.int64), None, 30,
                     capacity=1024)
    yield ("empty_store", empty.store, 0, bits.from_u64_np(q, device), 30)
    s = spectrum(np.arange(10, dtype=np.uint64), np.ones(10, np.int64), None,
                 30)
    yield ("only_sentinels", s.store, s.n_main,
           bits.from_u64_np(np.full(300, _SENT64), device), 30)
    # traveled entries, counts at the cap, the maximum key (whose key part
    # equals the sentinel's), sentinel queries
    for kb in (22, 37, 56):
        kmax = (1 << kb) - 1
        cap = sp.count_cap(kb)
        keys = np.array([0, 5, kmax - 1, kmax], np.uint64)
        s = spectrum(keys, np.array([1, cap, 7, cap]), np.array(
            [1, 0, 1, 1], np.uint8), kb)
        q = np.array([0, 0, 1, 5, kmax - 2, kmax - 1, kmax, kmax]
                     + [int(_SENT64)] * 5, np.uint64)
        yield (f"maxkey_kb{kb}", s.store, s.n_main,
               bits.from_u64_np(q, device), kb)
    # the maximum key queried but absent: only sentinels carry its key part
    s = spectrum(np.array([1, 2], np.uint64), np.array([3, 4]), None, 22)
    q = np.array([1, (1 << 22) - 1, int(_SENT64)], np.uint64)
    yield ("maxkey_absent", s.store, s.n_main, bits.from_u64_np(q, device), 22)


def k2_big_case(store, n_main, key_bits, n_q=9 << 24, seed=6):
    """The graph probes' real shape against phase 2's store: 9 x 2^24
    ascending probe keys, half of them stored keys, with a sentinel tail."""
    import torch

    from sh_assembly_tpu_torch.ops import bits, spectrum as sp

    g = torch.Generator(device=store.device).manual_seed(seed)
    half = n_q // 2
    pick = torch.randint(0, n_main, (half,), generator=g, device=store.device)
    hits = bits.srl(store[pick], sp.payload_bits(key_bits))
    fresh = torch.randint(0, 1 << key_bits, (n_q - half - n_q // 64,),
                          generator=g, device=store.device)
    q = torch.sort(torch.cat([hits, fresh])).values
    return torch.cat([q, torch.full((n_q // 64,), -1, dtype=torch.int64,
                                    device=store.device)])


def _rand_kmers(rng, n: int, k: int):
    """n random left-aligned packed k-mers as numpy uint64 (hi, lo)."""
    hi = np.frombuffer(rng.bytes(8 * n), np.uint64).copy()
    lo = np.frombuffer(rng.bytes(8 * n), np.uint64).copy()
    if 2 * k <= 64:
        hi &= ~np.uint64((1 << (64 - 2 * k)) - 1)
        lo[:] = 0
    else:
        lo &= ~np.uint64((1 << (128 - 2 * k)) - 1)
    return hi, lo


def _k3_stream(device, hi, lo, seed, pad=0):
    """A (hi, lo, nflag) stream sorted on (hi, lo, nflag), pad sentinels
    appended, as device tensors (nflag = 1 - seed)."""
    from sh_assembly_tpu_torch.ops import bits

    nf = np.where(seed, 0, 1).astype(np.uint8)
    o = np.lexsort((nf, lo, hi))
    hi = np.concatenate([hi[o], np.full(pad, _SENT64)])
    lo = np.concatenate([lo[o], np.full(pad, _SENT64)])
    nf = np.concatenate([nf[o], np.ones(pad, np.uint8)])
    import torch

    return (bits.from_u64_np(hi, device), bits.from_u64_np(lo, device),
            torch.from_numpy(nf).to(device))


def k3_cases(device):
    """(name, a_hi, a_lo, a_nf, na, b_hi, b_lo, b_nf, cap) tuples for K3:
    a node store (na live entries, sentinel tail) and sorted flush
    survivors (sentinel tail), made from numpy seeds."""

    def case(name, seed, k, na, nb, overlap, cap=None, pad=0, seed_p=0.4,
             rep=1):
        rng = np.random.default_rng(seed)
        hi, lo = _rand_kmers(rng, 2 * (na + nb) + 64, k)
        a = np.arange(na) // rep  # rep > 1: runs of duplicates in a
        n_ov = min(int(nb * overlap), na)
        b = np.concatenate([rng.choice(max(na, 1), size=n_ov) // rep,
                            na + rng.integers(0, na + nb + 64,
                                              size=nb - n_ov)])
        cap = cap or na + nb + 16
        ah, al, af = _k3_stream(device, hi[a], lo[a],
                                rng.random(na) < seed_p, cap - na)
        bh, bl, bf = _k3_stream(device, hi[b], lo[b],
                                rng.random(nb) < seed_p, pad)
        return name, ah, al, af, na, bh, bl, bf, cap

    # the cases of tests/test_merge128_pallas.py (k = 31)
    for i, (na, nb, ov) in enumerate([(500, 700, 0.3), (1500, 100, 0.9),
                                      (0, 800, 0.0), (800, 0, 0.0)]):
        yield case(f"m128_{i}", i, 31, na, nb, ov)
    yield case("long_runs", 4, 31, 2000, 1500, 1.0, seed_p=0.1, rep=300)
    # seeded copies on both sides, duplicates inside the survivors
    yield case("seeded_both", 5, 47, 3000, 6000, 0.9, seed_p=0.5, pad=50)
    # many tiles, k = 47 (the main path's k), a sentinel tail
    yield case("tiles_k47", 6, 47, 40_000, 60_000, 0.5, pad=5000)
    yield case("k63", 7, 63, 3000, 3000, 0.5, pad=10)
    # more survivors than the store holds: n_live reports the true count
    yield case("overflow", 8, 47, 5000, 8000, 0.2, cap=9000)
    yield case("empty", 9, 47, 0, 0, 0.0, pad=7)
    # k = 62 poly-T: hi is all ones, so only the pair marks a sentinel
    rng = np.random.default_rng(10)
    hi, lo = _rand_kmers(rng, 400, 62)
    t_hi = np.full(8, _SENT64)
    t_lo = np.full(8, np.uint64(0xFFFFFFFFFFFFFFF0))
    t_lo[1:] &= ~(np.arange(1, 8, dtype=np.uint64) << np.uint64(4))
    a_hi, a_lo = np.concatenate([hi[:300], t_hi[:4]]), np.concatenate(
        [lo[:300], t_lo[:4]])
    b_hi, b_lo = np.concatenate([hi[200:], t_hi[2:]]), np.concatenate(
        [lo[200:], t_lo[2:]])
    ah, al, af = _k3_stream(device, a_hi, a_lo, rng.random(304) < 0.5, 208)
    bh, bl, bf = _k3_stream(device, b_hi, b_lo, rng.random(206) < 0.5, 20)
    yield "k62_polyT", ah, al, af, 304, bh, bl, bf, 512


def k3_big_case(device, n_store=12_000_000, cap=1 << 24, n_b=1 << 22,
                k=47, seed=9):
    """One node-store fold at the main path's real shape, generated on the
    card: a 2^24-slot store with ~12 M live k-mers against 2^22 sorted
    survivors, half of them stored k-mers, a quarter sentinels."""
    import torch

    from sh_assembly_tpu_torch.ops import kmerpack as kp

    g = torch.Generator(device=device).manual_seed(seed)

    def rand_words(n):
        return torch.randint(-(1 << 63), (1 << 63) - 1, (n,), generator=g,
                             device=device)

    lo_mask = ~((1 << (128 - 2 * k)) - 1)
    hi, lo = rand_words(n_store), rand_words(n_store) & lo_mask
    perm = kp.sort_pairs(hi, lo)
    a_hi = torch.full((cap,), -1, dtype=torch.int64, device=device)
    a_lo = torch.full((cap,), -1, dtype=torch.int64, device=device)
    a_nf = torch.ones(cap, dtype=torch.uint8, device=device)
    a_hi[:n_store], a_lo[:n_store] = hi[perm], lo[perm]
    a_nf[:n_store] = (torch.rand(n_store, generator=g, device=device)
                      > 0.1).to(torch.uint8)
    n_hit, n_sent = n_b // 2, n_b // 4
    pick = torch.randint(0, n_store, (n_hit,), generator=g, device=device)
    n_new = n_b - n_hit - n_sent
    b_hi = torch.cat([hi[pick], rand_words(n_new),
                      torch.full((n_sent,), -1, dtype=torch.int64,
                                 device=device)])
    b_lo = torch.cat([lo[pick], rand_words(n_new) & lo_mask,
                      torch.full((n_sent,), -1, dtype=torch.int64,
                                 device=device)])
    b_nf = (torch.rand(n_b, generator=g, device=device) > 0.1).to(torch.uint8)
    b_nf[n_b - n_sent:] = 1
    perm = kp.sort_pairs(b_hi, b_lo, b_nf)
    return (a_hi, a_lo, a_nf, n_store, b_hi[perm].contiguous(),
            b_lo[perm].contiguous(), b_nf[perm].contiguous(), cap)


def big_case(device, n_live=100_000_000, n_buf=1 << 27, key_bits=37,
             capacity=1 << 29, seed=5):
    """One merge at the counting stage's real size, generated on the card:
    n_live distinct keys in the store, a full buffer of which half hits
    stored keys, 5% of slots empty."""
    import torch

    from sh_assembly_tpu_torch.ops import spectrum as sp

    g = torch.Generator(device=device).manual_seed(seed)
    keys = torch.unique(torch.randint(0, 1 << key_bits, (n_live + n_live // 50,),
                                      generator=g, device=device))[:n_live]
    n = keys.numel()
    counts = torch.randint(1, 200, (n,), generator=g, device=device)
    trav = torch.randint(0, 2, (n,), generator=g, device=device)
    kshift, cb = sp.payload_bits(key_bits), sp.cbits(key_bits)
    store = torch.full((capacity,), -1, dtype=torch.int64, device=device)
    store[:n] = (keys << kshift) | (trav << cb) | counts
    pick = torch.randint(0, n, (n_buf,), generator=g, device=device)
    fresh = torch.randint(0, 1 << key_bits, (n_buf,), generator=g,
                          device=device)
    u = torch.rand(n_buf, generator=g, device=device)
    buf = torch.where(u < 0.5, keys[pick], fresh)
    buf = torch.where(u > 0.95, -1, buf)
    del keys, counts, trav, pick, fresh, u
    return store, sp.sort_pack_buf(buf, key_bits), n, key_bits, capacity


def k4_cases(device):
    """(name, x, W) tuples for K4: int32 tensors carrying u32 patterns,
    made from numpy seeds.  The window counts leave ragged last chunks
    where the window is below the kernel's shared-memory chunk (2^13)."""
    import torch

    for log2_w, g in ((7, 5), (7, 200), (10, 7), (10, 19), (13, 1), (13, 5),
                      (15, 3), (17, 2)):
        W = 1 << log2_w
        rng = np.random.default_rng(log2_w * 1000 + g)
        x = rng.integers(0, 1 << 32, size=g * W,
                         dtype=np.uint64).astype(np.uint32)
        fills = {"random": x, "equal": np.full_like(x, 0x9E3779B9),
                 "sorted": np.sort(x), "reversed": np.sort(x)[::-1].copy(),
                 "extremes": np.where(x & 1, 0xFFFFFFFF, 0).astype(np.uint32)}
        for fill, v in fills.items():
            yield (f"w2^{log2_w}_g{g}_{fill}",
                   torch.from_numpy(v.view(np.int32)).to(device), W)


def _merged_spectrum(store, n, key_bits):
    """A merged Spectrum around a packed store with n live entries."""
    import torch

    from sh_assembly_tpu_torch.ops import spectrum as sp

    cmask = (1 << sp.cbits(key_bits)) - 1
    return sp.Spectrum(
        store=store, buf=torch.full((1 << 10,), -1, dtype=torch.int64,
                                    device=store.device),
        n_main=n, n_buf=0, ndistinct=n, nelts=(store[:n] & cmask).sum())


def setops_pair(device, n_live, capacity, key_bits=37, seed=13):
    """Two merged spectra generated on the device: n_live distinct keys
    each, about half of b's keys stored in a too, a few counts at the cap,
    half of the entries traveled."""
    import torch

    from sh_assembly_tpu_torch.ops import spectrum as sp

    g = torch.Generator(device=device).manual_seed(seed)
    kshift, cb = sp.payload_bits(key_bits), sp.cbits(key_bits)

    def rand_keys(n):
        return torch.randint(0, 1 << key_bits, (n,), generator=g,
                             device=device)

    def spectrum(keys):
        n = keys.numel()
        counts = torch.randint(1, 200, (n,), generator=g, device=device)
        counts[::1000003] = sp.count_cap(key_bits)  # rare: sums stay in int64
        trav = torch.randint(0, 2, (n,), generator=g, device=device)
        store = torch.full((capacity,), -1, dtype=torch.int64, device=device)
        store[:n] = (keys << kshift) | (trav << cb) | counts
        return _merged_spectrum(store, n, key_bits)

    ka = torch.unique(rand_keys(n_live + n_live // 50))[:n_live]
    pick = torch.randint(0, ka.numel(), (n_live // 2,), generator=g,
                         device=device)
    kb = torch.unique(torch.cat([ka[pick], rand_keys(n_live)]))
    # thin b to n_live keys without losing its spread over the key range
    kb = kb[torch.randperm(kb.numel(), generator=g,
                           device=device)[:n_live].sort().values]
    return spectrum(ka), spectrum(kb)


def spectrum_cut(spec, n, capacity, key_bits, device):
    """The first n live entries of spec as a merged spectrum of its own on
    ``device``."""
    import torch

    store = torch.full((capacity,), -1, dtype=torch.int64, device=device)
    store[:n] = spec.store[:n].to(device)
    return _merged_spectrum(store, n, key_bits)


# ---------------------------------------------------------------------------
# Phases


def phase0_device():
    import torch

    print("== phase 0: device", flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this smoke run needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    return smi


def phase1_build():
    from concurrent.futures import ThreadPoolExecutor

    from sh_assembly_tpu_torch.ops import _build, blocksort_cuda, join_cuda, \
        merge128_cuda, merge_cuda

    print("== phase 1: build", flush=True)
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)  # build from source
    t0 = time.time()
    # one nvcc per source, all started together
    with ThreadPoolExecutor(4) as ex:
        for f in [ex.submit(m.build) for m in (merge_cuda, join_cuda,
                                               merge128_cuda, blocksort_cuda)]:
            f.result()
    for name in ("merge_dedup", "count_join", "merge128", "block_sort"):
        print(f"built {name} (sm_90a) -> {_build.lib_path(name)}")
    print(f"  all kernels built in {time.time() - t0:.2f} s")


def _time_ms(fn, reps: int) -> float:
    """Median over reps calls of fn's time between CUDA events."""
    from sh_assembly_tpu_torch.utils.profiling import median_ms

    return median_ms(fn, reps, "cuda")


def _compare(name, kern, plain) -> int:
    import torch

    (ok, nk, dk), (op, np_, dp) = kern, plain
    torch.cuda.synchronize()
    if int(nk) != int(np_) or int(dk) != int(dp) or not torch.equal(ok, op):
        bad = int((ok != op).sum())
        raise AssertionError(
            f"K1 != plain twin on {name}: n_live {int(nk)} vs {int(np_)}, "
            f"n_dropped {int(dk)} vs {int(dp)}, {bad} words differ")
    return int((ok - op).abs().max()) if ok.numel() else 0


def phase2_k1(device):
    import torch

    from sh_assembly_tpu_torch.ops import merge_cuda as mc

    print("== phase 2: K1 against its plain twin", flush=True)
    err = 0
    for name, main, buf, n_main, kb, drop, C in k1_cases(device):
        kern = mc.merge_dedup_cuda(main, buf, n_main, kb, drop, C)
        plain = mc.merge_dedup_plain(main, buf, n_main, kb, drop, C)
        err = max(err, _compare(name, kern, plain))
        if name == "overflow" and int(kern[1]) <= C:
            raise AssertionError("the overflow case did not overflow")
        print(f"  {name}: n_main={n_main} buf={buf.numel()} kb={kb} "
              f"drop={drop} C={C} -> n_live={int(kern[1])} "
              f"n_dropped={int(kern[2])} identical")

    store, buf, n, kb, C = big_case(device)
    print(f"  real size: n_main={n} buf={buf.numel()} key_bits={kb} "
          f"capacity={C}", flush=True)
    timing = {}
    for label, b, drop in (("merge", buf, False), ("sweep", buf[:0], True)):
        kern = mc.merge_dedup_cuda(store, b, n, kb, drop, C)
        plain = mc.merge_dedup_plain(store, b, n, kb, drop, C)
        err = max(err, _compare(f"real-size {label}", kern, plain))
        n_live, n_drop = int(kern[1]), int(kern[2])
        del kern, plain
        ms = _time_ms(lambda: mc.merge_dedup_cuda(store, b, n, kb, drop, C), 7)
        plain_ms = _time_ms(
            lambda: mc.merge_dedup_plain(store, b, n, kb, drop, C), 3)
        # the live store and the buffer read and the live result written:
        # a design may skip the sentinel tail, so the bound leaves it out;
        # one key comparison for each word read
        moved = (n + b.numel() + n_live) * 8
        whole = (n + b.numel() + C) * 8  # what K1 moves: the tail as well
        timing[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                             **bound(moved, n + b.numel()))
        print(f"  real-size {label}: n_live={n_live} n_dropped={n_drop} "
              f"identical; K1 median {ms:.3f} ms, plain twin median "
              f"{plain_ms:.3f} ms; K1 moves >= {whole / 2**30:.2f} GiB "
              f"-> {whole / ms / 1e6:.1f} GB/s; bound "
              f"{timing[label]['bound_ms']:.3f} ms for the {moved / 1e9:.2f} "
              f"GB of the live result ({bound_ms(whole):.3f} ms if all "
              f"{C} slots count)")
    del store, buf
    torch.cuda.empty_cache()
    return err, timing


def _run_main(main, argv):
    """Run an entry point's main(argv) in-process, echoing and capturing
    what it writes to stderr.  Returns (exit code, log text, seconds)."""

    class Tee(io.TextIOBase):
        def __init__(self):
            self.buf = io.StringIO()

        def write(self, s):
            sys.__stderr__.write(s)
            return self.buf.write(s)

    tee = Tee()
    t0 = time.time()
    with contextlib.redirect_stderr(tee):
        rc = main(argv)
    return rc, tee.buf.getvalue(), time.time() - t0


def _run_cli(argv, cli: str = "cqf_denoise"):
    """Run one of the port's CLIs in-process (it must exit 0); for
    cqf_denoise, also parse its final counters."""
    import importlib

    rc, logtxt, wall = _run_main(importlib.import_module(
        f"sh_assembly_tpu_torch.cli.{cli}").main, argv)
    if rc != 0:
        raise RuntimeError(f"{cli} exited {rc}")
    stats = {}
    for line in logtxt.splitlines():
        if "kmers=" in line and "merges=" in line:
            stats = dict(kv.split("=") for kv in line.split("] ", 1)[1].split())
    return {k: int(v) for k, v in stats.items()}, logtxt, wall


def _ser_meta(path):
    from sh_assembly_tpu_torch.formats import cqf_ser

    with open(path, "rb") as f:
        return cqf_ser._unpack_metadata(f.read(128))


PARITY = dict(genome_len=1_000_000, n_reads=200_000, read_len=150,
              sub_rate=0.003, n_rate=0.0005, seed=7)
PARITY_FLAGS = ["-k", "31", "-n", "1000000", "-N", "24000000", "-e", "0.005"]


def phase3_parity():
    print("== phase 3: CPU and CUDA .ser byte identity", flush=True)
    d = os.path.join(WORK, "parity")
    os.makedirs(d, exist_ok=True)
    write_fastq(os.path.join(d, "reads.fastq"), **PARITY)
    out = {}
    for dev in ("cpu", "cuda"):
        ser = os.path.join(d, f"{dev}.ser")
        stats, logtxt, wall = _run_cli(
            PARITY_FLAGS + ["-i", os.path.join(d, "ReadFiles.txt"),
                            "-o", ser, "--device", dev])
        mid = logtxt.count("deNoise sweep ") - logtxt.count(
            "deNoise sweep done")
        print(f"  {dev}: {stats} mid-stream sweeps={mid} wall {wall:.1f} s")
        out[dev] = (open(ser, "rb").read(), stats, mid)
    if out["cpu"][0] != out["cuda"][0]:
        raise AssertionError("CPU and CUDA .ser files differ")
    if out["cuda"][2] < 1:
        raise AssertionError("no deNoise sweep fired mid-stream")
    print(f"  .ser files byte-identical ({len(out['cpu'][0])} bytes)")


MAIN = dict(genome_len=100_000_000, n_reads=3_000_000, read_len=150,
            sub_rate=0.00234, n_rate=0.0002, seed=47)
MAIN_FLAGS = ["-k", "47", "-N", "16506371070", "-n", "119157843",
              "-e", "0.00234", "--endDeNoise"]


def phase4_main():
    import torch

    from sh_assembly_tpu_torch import config as cfg
    from sh_assembly_tpu_torch.ops import merge_cuda as mc
    from sh_assembly_tpu_torch.utils import profiling

    print("== phase 4: main path at real state size", flush=True)
    d = os.path.join(WORK, "main")
    os.makedirs(d, exist_ok=True)
    t0 = time.time()
    write_fastq(os.path.join(d, "reads.fastq"), **MAIN)
    print(f"  wrote {MAIN['n_reads']} reads x {MAIN['read_len']} bp from a "
          f"{MAIN['genome_len']} bp genome in {time.time() - t0:.1f} s")
    sz = cfg.size_counter(k=47, n_true_kmers=119157843,
                          total_kmers=16506371070, alpha=0.00234,
                          end_deNoise=True)
    kmers_in = MAIN["n_reads"] * (MAIN["read_len"] - 47 + 1)
    print(f"  state: qb={sz.qb} key_bits={sz.hb} store 2^{sz.qb} slots "
          f"({(8 << sz.qb) / 2**30:.0f} GiB); traffic cut from "
          f"16506371070 to ~{kmers_in} k-mers ({kmers_in / 16506371070:.4f}x)"
          f"; state size not cut")
    ser = os.path.join(d, "main.ser")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mc.LAUNCHES = 0
    stats, _, wall = _run_cli(MAIN_FLAGS + [
        "-i", os.path.join(d, "ReadFiles.txt"), "-o", ser, "--device", "cuda"])
    launches = mc.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    count_s = sum(s.seconds for n, s in profiling.GLOBAL.stats.items()
                  if n != "count:serialize")
    meta = _ser_meta(ser)
    print(f"  {stats}; K1 launches {launches}")
    if launches < stats["merges"] + stats["sweeps"] or stats["merges"] < 3:
        raise AssertionError(f"K1 launches {launches} < merges + sweeps")
    if meta.nslots != 1 << sz.qb or meta.key_bits != sz.hb or \
            meta.nelts != stats["kmers"] or \
            meta.ndistinct_elts != stats["distinct"]:
        raise AssertionError(f".ser header {meta} disagrees with {stats}")
    if not 0 < stats["distinct"] <= stats["kmers"] <= kmers_in:
        raise AssertionError(f"implausible counts {stats}")
    rate = stats["kmers"] / count_s
    print(f"  .ser header agrees: nslots={meta.nslots} nelts={meta.nelts} "
          f"ndistinct={meta.ndistinct_elts}")
    print(f"  counting {count_s:.2f} s ({rate:.0f} k-mers/s), CLI wall "
          f"{wall:.2f} s incl. serialize; peak device memory "
          f"{peak / 2**30:.2f} GiB")
    return launches


def _max_abs(pairs) -> int:
    """Largest absolute difference over (kernel, plain) tensor pairs."""
    return max((int((a.long() - b.long()).abs().max()) if a.numel() else 0)
               for a, b in pairs)


def _check_k2(name, kern, plain) -> int:
    import torch

    torch.cuda.synchronize()
    if not torch.equal(kern, plain):
        bad = int((kern != plain).sum())
        raise AssertionError(f"K2 != plain version on {name}: {bad} counts "
                             f"differ")
    return _max_abs([(kern, plain)])


def _check_k3(name, kern, plain) -> int:
    import torch

    torch.cuda.synchronize()
    if int(kern[3]) != int(plain[3]) or not all(
            torch.equal(a, b) for a, b in zip(kern[:3], plain[:3])):
        bad = [int((a != b).sum()) for a, b in zip(kern[:3], plain[:3])]
        raise AssertionError(
            f"K3 != plain version on {name}: n_live {int(kern[3])} vs "
            f"{int(plain[3])}, differing (hi, lo, nflag) entries {bad}")
    return _max_abs(zip(kern[:3], plain[:3]))


def phase5_k2_k3(device):
    """K2 and K3 against their plain versions, bitwise, then timed at the
    main path's real shapes.  Returns (k2 err, k3 err, timing)."""
    import torch

    from sh_assembly_tpu_torch.ops import bits
    from sh_assembly_tpu_torch.ops import join_cuda as jc
    from sh_assembly_tpu_torch.ops import merge128_cuda as m3
    from sh_assembly_tpu_torch.ops import spectrum as sp

    print("== phase 5: K2 and K3 against their plain versions", flush=True)
    err2 = err3 = 0
    for name, store, n_main, q, kb in k2_cases(device):
        err2 = max(err2, _check_k2(
            name, jc.count_join_cuda(store, n_main, q, kb),
            jc.count_join_plain(store, n_main, q, kb)))
        print(f"  K2 {name}: n_main={n_main} queries={q.numel()} kb={kb} "
              f"identical")
    for name, *args in k3_cases(device):
        kern = m3.merge128_cuda(*args)
        err3 = max(err3, _check_k3(name, kern, m3.merge128_plain(*args)))
        if name == "overflow" and int(kern[3]) <= args[-1]:
            raise AssertionError("the K3 overflow case did not overflow")
        print(f"  K3 {name}: na={args[3]} nb={args[4].numel()} "
              f"cap={args[-1]} -> n_live={int(kern[3])} identical")

    timing = {}
    store, _, n, kb, C = big_case(device)
    q = k2_big_case(store, n, kb)
    print(f"  K2 real shape: n_main={n} slots={C} key_bits={kb} "
          f"queries={q.numel()}", flush=True)
    err2 = max(err2, _check_k2("real shape", jc.count_join_cuda(
        store, n, q, kb), jc.count_join_plain(store, n, q, kb)))
    ms = _time_ms(lambda: jc.count_join_cuda(store, n, q, kb), 7)
    plain_ms = _time_ms(lambda: jc.count_join_plain(store, n, q, kb), 3)
    # the one PyTorch call for the search itself, on a key column and
    # clean queries prepared outside the timing
    skeys = bits.srl(store[:n], sp.payload_bits(kb))
    qk = torch.where(q == -1, 0, q)
    library_ms = _time_ms(lambda: torch.searchsorted(skeys, qk), 3)
    del skeys, qk
    # every query read (8 B) and answered (4 B), the live store read once;
    # a search of log2(n) comparisons for each query
    moved = q.numel() * 12 + n * 8
    timing["count_join"] = dict(ms=ms, plain_ms=plain_ms,
                                library_ms=library_ms,
                                **bound(moved, q.numel() * n.bit_length()))
    print(f"  K2 real shape identical; K2 median {ms:.3f} ms, plain median "
          f"{plain_ms:.3f} ms ({q.numel() / ms / 1e6:.1f} G queries/s); "
          f"torch.searchsorted alone {library_ms:.3f} ms; bound "
          f"{timing['count_join']['bound_ms']:.3f} ms for "
          f"{moved / 1e9:.2f} GB")
    del store, q
    torch.cuda.empty_cache()

    args = k3_big_case(device)
    print(f"  K3 real shape: na={args[3]} cap={args[-1]} "
          f"nb={args[4].numel()}", flush=True)
    kern = m3.merge128_cuda(*args)
    err3 = max(err3, _check_k3("real shape", kern, m3.merge128_plain(*args)))
    n_live = int(kern[3])
    del kern
    ms = _time_ms(lambda: m3.merge128_cuda(*args), 7)
    plain_ms = _time_ms(lambda: m3.merge128_plain(*args), 3)
    # 17 B an entry (hi, lo, flag): the live store and the survivors read
    # and the live result written (as for K1, not the sentinel tail); two
    # word comparisons for each entry read
    n_in = args[3] + args[4].numel()
    moved = (n_in + n_live) * 17
    whole = (n_in + args[-1]) * 17  # what K3 moves: the tail as well
    timing["merge128"] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                              **bound(moved, 2 * n_in))
    print(f"  K3 real shape: n_live={n_live} identical; K3 median {ms:.3f} "
          f"ms, plain median {plain_ms:.3f} ms; K3 moves >= "
          f"{whole / 2**30:.2f} GiB -> {whole / ms / 1e6:.1f} GB/s; bound "
          f"{timing['merge128']['bound_ms']:.3f} ms for the "
          f"{moved / 1e9:.2f} GB of the live result")
    del args
    torch.cuda.empty_cache()
    return err2, err3, timing


def _fasta_lengths(path: str) -> np.ndarray:
    lens, n = [], 0
    with open(path) as f:
        for line in f:
            if line.startswith(">"):
                if n:
                    lens.append(n)
                n = 0
            else:
                n += len(line.strip())
    if n:
        lens.append(n)
    return np.asarray(lens, np.int64)


def _n50(lens: np.ndarray) -> int:
    s = np.sort(lens)[::-1]
    c = np.cumsum(s)
    return int(s[np.searchsorted(c, c[-1] / 2)]) if len(s) else 0


def _reset_launches():
    from sh_assembly_tpu_torch.ops import join_cuda, merge128_cuda, \
        merge_cuda

    for m in (merge_cuda, join_cuda, merge128_cuda):
        m.LAUNCHES = 0


def _launches():
    from sh_assembly_tpu_torch.ops import join_cuda, merge128_cuda, \
        merge_cuda

    return {"merge_dedup": merge_cuda.LAUNCHES,
            "count_join": join_cuda.LAUNCHES,
            "merge128": merge128_cuda.LAUNCHES}


# the bench's end-to-end shape (bench.py): a 1 Mbp genome, 300 k reads of
# 100 bp, k = 47 and its flags
E2E = dict(genome_len=1_000_000, n_reads=300_000, read_len=100,
           sub_rate=0.001, n_rate=0.0, seed=11)
E2E_FLAGS = ["-k", "47", "-n", "1000000", "-N", str(300_000 * 54),
             "-e", "0.001", "--deNoise", "0"]


def phase6_pipeline_parity():
    print("== phase 6: CPU and CUDA pipeline (reads -> contigs) identity",
          flush=True)
    d = os.path.join(WORK, "e2e")
    os.makedirs(d, exist_ok=True)
    write_fastq(os.path.join(d, "reads.fastq"), **E2E)
    out = {}
    ser = os.path.join(d, "e2e.ser")
    for dev in ("cpu", "cuda"):
        _reset_launches()
        _, _, wall = _run_cli(E2E_FLAGS + [
            "-i", os.path.join(d, "ReadFiles.txt"),
            "-o", os.path.join(d, f"contigs_{dev}.fa"),
            "--unitigs", os.path.join(d, f"unitigs_{dev}.fa"),
            "--device", dev] + (["--save-cqf", ser] if dev == "cpu" else []),
            cli="pipeline")
        launches = _launches()
        files = [open(os.path.join(d, f"{f}_{dev}.fa"), "rb").read()
                 for f in ("unitigs", "contigs")]
        print(f"  {dev}: wall {wall:.1f} s, kernel launches {launches}, "
              f"unitigs.fa {len(files[0])} B, contigs.fa {len(files[1])} B")
        out[dev] = (files, launches)
    for i, f in enumerate(("unitigs.fa", "contigs.fa")):
        if out["cpu"][0][i] != out["cuda"][0][i]:
            raise AssertionError(f"CPU and CUDA {f} differ")
    if any(out["cpu"][1].values()):
        raise AssertionError("a kernel launched in the CPU run")
    if not all(out["cuda"][1].values()):
        raise AssertionError(f"a kernel never launched in the CUDA run: "
                             f"{out['cuda'][1]}")
    print("  unitigs.fa and contigs.fa byte-identical")

    # the Contiger's own entry point on the card, from the CPU run's .ser
    _reset_launches()
    _, _, wall = _run_cli([
        "-k", E2E_FLAGS[1], "-i", os.path.join(d, "ReadFiles.txt"),
        "-c", ser, "-o", os.path.join(d, "unitigs_cli.fa"),
        "--device", "cuda"], cli="contiger")
    launches = _launches()
    print(f"  cli.contiger cuda: wall {wall:.1f} s, kernel launches "
          f"{launches}")
    if open(os.path.join(d, "unitigs_cli.fa"), "rb").read() != \
            out["cpu"][0][0]:
        raise AssertionError("cli.contiger's CUDA unitigs.fa differs from "
                             "the CPU pipeline's")
    if not (launches["count_join"] and launches["merge128"]):
        raise AssertionError(f"K2 or K3 never launched in cli.contiger: "
                             f"{launches}")
    print("  cli.contiger's CUDA unitigs.fa byte-identical to the CPU "
          "pipeline's")


# the main path at the size of a genome users assemble: S. cerevisiae
# (12 Mbp), 30x of 150 bp reads from both strands
GENOME = dict(genome_len=12_000_000, n_reads=2_400_000, read_len=150,
              sub_rate=0.00234, n_rate=0.0, seed=12)
GENOME_FLAGS = ["-k", "47", "-n", "12000000",
                "-N", str(2_400_000 * (150 - 47 + 1)),
                "-e", "0.00234", "--endDeNoise"]


def phase7_genome():
    import torch

    from sh_assembly_tpu_torch.io import native
    from sh_assembly_tpu_torch.models import contiger
    from sh_assembly_tpu_torch.utils import profiling

    print("== phase 7: reads -> contigs on a 12 Mbp genome", flush=True)
    d = os.path.join(WORK, "genome")
    os.makedirs(d, exist_ok=True)
    t0 = time.time()
    write_fastq(os.path.join(d, "reads.fastq"), **GENOME)
    print(f"  wrote {GENOME['n_reads']} reads x {GENOME['read_len']} bp "
          f"from a {GENOME['genome_len']} bp genome in "
          f"{time.time() - t0:.1f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # count calls of the torch contraction, which runs only when the native
    # one is missing or fails
    fallback = []
    torch_contract = contiger.contract_paths
    contiger.contract_paths = lambda cn: fallback.append(1) or \
        torch_contract(cn)
    _reset_launches()
    try:
        _, logtxt, wall = _run_cli(GENOME_FLAGS + [
            "-i", os.path.join(d, "ReadFiles.txt"),
            "-o", os.path.join(d, "contigs.fa"),
            "--unitigs", os.path.join(d, "unitigs.fa"), "--device", "cuda"],
            cli="pipeline")
    finally:
        contiger.contract_paths = torch_contract
    launches = _launches()
    peak = torch.cuda.max_memory_allocated()
    lib = native._load()
    if lib is None or not hasattr(lib, "shc_contract") or fallback:
        raise AssertionError("the native contraction library did not run")
    print("  phase breakdown:")
    for name, s in sorted(profiling.GLOBAL.stats.items(),
                          key=lambda kv: -kv[1].seconds):
        print(f"    {name:<26} {s.seconds:9.3f} s ({s.calls} calls)")
    nodes = phantoms = 0
    for line in logtxt.splitlines():
        if "distinct solid k-mers" in line:
            nodes = int(line.split("] ")[-1].split()[0])
        if "phantom hash-collision nodes added" in line:
            phantoms = int(line.split("] ")[-1].split()[0])
    ulens = _fasta_lengths(os.path.join(d, "unitigs.fa"))
    clens = _fasta_lengths(os.path.join(d, "contigs.fa"))
    total = int(clens.sum())
    print(f"  nodes {nodes}, phantoms {phantoms}; unitigs {len(ulens)} "
          f"(N50 {_n50(ulens)}); contigs {len(clens)}, total {total} bp, "
          f"N50 {_n50(clens)}")
    print(f"  pipeline wall {wall:.2f} s; peak device memory "
          f"{peak / 2**30:.2f} GiB; kernel launches {launches}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel never launched: {launches}")
    if abs(total - GENOME["genome_len"]) > 0.1 * GENOME["genome_len"]:
        raise AssertionError(f"contigs total {total} bp not within 10% of "
                             f"the {GENOME['genome_len']} bp genome")
    return launches


def phase8_k4(device):
    """K4 against its plain version, bitwise, then the profiling entry
    point at its real shape.  Returns (err, launches, timing)."""
    import torch

    from sh_assembly_tpu_torch.ops import blocksort_cuda as bs
    from sh_assembly_tpu_torch.profile import blocksort as prof
    from sh_assembly_tpu_torch.profile import sort as psort

    print("== phase 8: K4 against its plain version", flush=True)
    err = n = 0
    for name, x, W in k4_cases(device):
        kern, plain = bs.block_sort_cuda(x, W), bs.block_sort_plain(x, W)
        torch.cuda.synchronize()
        if not torch.equal(kern, plain):
            raise AssertionError(
                f"K4 != plain version on {name}: "
                f"{int((kern != plain).sum())} of {x.numel()} values differ")
        err = max(err, _max_abs([(kern, plain)]))
        n += 1
    print(f"  {n} cases (windows 2^7..2^17; random, equal, sorted, reversed, "
          f"extremes) identical")
    bs.LAUNCHES = 0
    _, logtxt, _ = _run_main(prof.main, [])  # its own checks raise
    launches = bs.LAUNCHES
    r = prof.LAST
    if "correct: True" not in logtxt or not launches:
        raise AssertionError("profile.blocksort did not check its output")
    # every value read once and written once; a comparison sort of a
    # window needs log2(W) comparisons a value
    moved = 2 * 4 * r["n"]
    timing = dict(ms=r["ms"], plain_ms=r["plain_ms"],
                  library_ms=r["plain_ms"],
                  **bound(moved, r["n"] * (r["w"].bit_length() - 1)))
    print(f"  real shape N=2^27 W=2^17: identical; K4 median {r['ms']:.3f} "
          f"ms ({r['ms'] / r['n'] * 1e6:.4f} ns/element), plain torch.sort "
          f"rows (also the library call) median {r['plain_ms']:.3f} ms; "
          f"bound {timing['bound_ms']:.3f} ms for {moved / 2**30:.2f} GiB; "
          f"K4 launches {launches}")
    torch.cuda.empty_cache()
    # the buffer-sort yardsticks beside it, as profile.sort runs them
    _, logtxt, wall = _run_main(psort.main, [])
    lines = [ln.split("] ", 1)[-1] for ln in logtxt.splitlines()
             if " ms  (" in ln]
    if len(lines) != len(psort.VARIANTS):
        raise AssertionError("profile.sort did not time every variant")
    print(f"  profile.sort, 2^27 keys of 36 bits, medians of 3 "
          f"({wall:.1f} s):")
    for ln in lines:
        print(f"    {ln}")
    torch.cuda.empty_cache()
    return err, launches, timing


def _same_spectrum(a, b, what):
    import torch

    if (a.n_main, a.ndistinct, int(a.nelts)) != (
            b.n_main, b.ndistinct, int(b.nelts)) or not torch.equal(
            a.store.cpu(), b.store.cpu()):
        raise AssertionError(f"{what}: CUDA and CPU spectra differ")


def _library_results(ca, cb, probes, kb):
    """Every library function of phase 9 on one pair of spectra."""
    from sh_assembly_tpu_torch.ops import join_cuda as jc
    from sh_assembly_tpu_torch.ops import spectrum as sp

    before = jc.LAUNCHES
    r = dict(union=sp.union(ca, cb, kb), intersect=sp.intersect(ca, cb, kb),
             inner=int(sp.inner_product(ca, cb, kb)),
             mag=float(sp.magnitude(ca, kb)))
    r["k2"] = jc.LAUNCHES - before
    c1, w1, ca = sp.query_set_traveled(ca, probes, kb)  # marks ca in place
    c2, w2 = sp.query_is_traveled(ca, probes, kb)
    r.update(c1=c1.cpu(), w1=w1.cpu(), c2=c2.cpu(), w2=w2.cpu(), after=ca)
    return r


def library_cut(device, a, b, kb, m=200_000, Cm=1 << 18):
    """A cut of the same keys through the CPU and the card."""
    import torch

    from sh_assembly_tpu_torch.ops import bits
    from sh_assembly_tpu_torch.ops import spectrum as sp

    g = torch.Generator().manual_seed(3)
    probes = torch.cat([
        bits.srl(a.store[:m].cpu()[torch.randint(
            0, m, (m // 4,), generator=g)], sp.payload_bits(kb)),
        torch.randint(0, 1 << kb, (m // 4,), generator=g),
        torch.full((100,), -1, dtype=torch.int64)])
    probes = probes[torch.randperm(probes.numel(), generator=g)]
    rc, rg = (_library_results(spectrum_cut(a, m, Cm, kb, d),
                               spectrum_cut(b, m, Cm, kb, d),
                               probes.to(d), kb) for d in ("cpu", device))
    for f in ("union", "intersect", "after"):
        _same_spectrum(rg[f], rc[f], f)
    for f in ("c1", "w1", "c2", "w2"):
        if not torch.equal(rg[f], rc[f]):
            raise AssertionError(f"traveled query {f}: CUDA and CPU differ")
    if rg["inner"] != rc["inner"] or abs(rg["mag"] - rc["mag"]) > \
            1e-9 * rc["mag"]:
        raise AssertionError(f"inner_product or magnitude differ: {rg['inner']}"
                             f" vs {rc['inner']}, {rg['mag']} vs {rc['mag']}")
    if rc["k2"] != 0 or rg["k2"] != 2:
        raise AssertionError(f"K2 launches in the set operations: CPU "
                             f"{rc['k2']}, CUDA {rg['k2']} (expected 0 and 2)")
    if not (0 < rc["intersect"].n_main < m < rc["union"].n_main
            and rc["w2"].sum() > rc["w1"].sum() > 0):
        raise AssertionError("the cut exercises no overlap or no traveled bit")
    print(f"  cut of {m} keys each: union {rc['union'].n_main}, intersect "
          f"{rc['intersect'].n_main}, inner_product {rc['inner']}, magnitude "
          f"{rc['mag']:.6f}, traveled before/after the batch "
          f"{int(rc['w1'].sum())}/{int(rc['w2'].sum())}: CUDA = CPU; "
          f"K2 launches on CUDA {rg['k2']}")


def _library_full(device, a, b, kb, n_q=1 << 24):
    """The set operations and traveled queries on the full state, held to
    identities that need no second implementation."""
    import torch

    from sh_assembly_tpu_torch.ops import bits
    from sh_assembly_tpu_torch.ops import join_cuda as jc
    from sh_assembly_tpu_torch.ops import spectrum as sp

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.time() - t0) * 1e3

    torch.cuda.reset_peak_memory_stats()
    before = jc.LAUNCHES
    u, t_u = timed(lambda: sp.union(a, b, kb))
    n_u, nelts_u = u.n_main, int(u.nelts)
    del u
    x, t_x = timed(lambda: sp.intersect(a, b, kb))
    ip, t_ip = timed(lambda: int(sp.inner_product(a, b, kb)))
    mag, t_m = timed(lambda: float(sp.magnitude(a, kb)))
    self_ip = int(sp.inner_product(a, a, kb))
    same = sp.intersect(a, a, kb)
    k2 = jc.LAUNCHES - before
    if n_u + x.n_main != a.n_main + b.n_main or not 0 < x.n_main < a.n_main:
        raise AssertionError(f"|A u B| + |A n B| != |A| + |B|: {n_u}, "
                             f"{x.n_main}, {a.n_main}, {b.n_main}")
    if nelts_u != int(a.nelts) + int(b.nelts) or ip <= 0:
        raise AssertionError("union nelts or inner_product is wrong")
    if not torch.equal(same.store, a.store) or int(same.nelts) != \
            int(a.nelts) or abs(self_ip - mag * mag) > 1e-9 * self_ip:
        raise AssertionError("intersect(a, a) != a or <a, a> != |a|^2")
    if k2 != 4:
        raise AssertionError(f"K2 launched {k2} times, expected 4")
    del same, x
    gq = torch.Generator(device=device).manual_seed(4)
    probes = torch.cat([
        bits.srl(a.store[torch.randint(0, a.n_main, (n_q // 2,), generator=gq,
                                       device=device)], sp.payload_bits(kb)),
        torch.randint(0, 1 << kb, (n_q // 2,), generator=gq, device=device)])
    (c0, w0), _ = timed(lambda: sp.query_is_traveled(a, probes, kb))
    (c1, w1, a), t_set = timed(lambda: sp.query_set_traveled(a, probes, kb))
    (c2, w2), t_is = timed(lambda: sp.query_is_traveled(a, probes, kb))
    if not (torch.equal(c0, c1) and torch.equal(c1, c2)
            and torch.equal(w0, w1) and torch.equal(w2, c1 > 0)
            and 0 < int(w1.sum()) < int(w2.sum())):
        raise AssertionError("traveled queries at full size are inconsistent")
    peak = torch.cuda.max_memory_allocated()
    print(f"  full state on the card: union {n_u} keys in {t_u:.1f} ms, "
          f"intersect in {t_x:.1f} ms, inner_product {ip} in {t_ip:.1f} ms, "
          f"magnitude {mag:.3f} in {t_m:.1f} ms; {n_q} probes: "
          f"query_set_traveled {t_set:.1f} ms, query_is_traveled {t_is:.1f} "
          f"ms ({int(w1.sum())} -> {int(w2.sum())} traveled); K2 launches "
          f"{k2}; peak device memory {peak / 2**30:.2f} GiB")


def phase9_library(device):
    import torch

    print("== phase 9: set operations, traveled queries and tools",
          flush=True)
    kb, C, n_live = 37, 1 << 27, 50_000_000
    a, b = setops_pair(device, n_live, C, kb)
    print(f"  two spectra of {a.n_main} and {b.n_main} live keys in 2^27 "
          f"slots, key_bits {kb}")
    library_cut(device, a, b, kb)
    _library_full(device, a, b, kb)
    del a, b
    torch.cuda.empty_cache()
    # the tools on phase 6's files
    from sh_assembly_tpu_torch.cli import compare_contigs, cqf_dump, minia

    d = os.path.join(WORK, "e2e")
    k = E2E_FLAGS[1]
    mfa = os.path.join(d, "minia_contigs.fa")
    rc, _, wall = _run_main(minia.main, [
        "-kmer-size", k, "-in", os.path.join(d, "unitigs_cuda.fa"),
        "-unitig", "-out", mfa])
    if rc != 0:
        raise AssertionError(f"cli.minia exited {rc}")
    for what, fa in (("cli.minia's contigs and the pipeline's", mfa),
                     ("the CPU and the CUDA contigs",
                      os.path.join(d, "contigs_cpu.fa"))):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = compare_contigs.main(
                ["-k", k, fa, os.path.join(d, "contigs_cuda.fa")])
        print("    " + out.getvalue().strip().replace("\n", "\n    "))
        if rc != 0 or "(1.0000 jaccard)" not in out.getvalue():
            raise AssertionError(f"{what} are not the same set of sequences")
        print(f"  cli.compare_contigs: {what} are the same set of sequences")
    ser = os.path.join(d, "e2e.ser")
    meta = _ser_meta(ser)
    rc, header, _ = _run_main(cqf_dump.main, [ser, "--meta-only"])
    for field in (f"nslots={meta.nslots} ", f"key_bits={meta.key_bits} ",
                  f"nelts={meta.nelts} ",
                  f"ndistinct_elts={meta.ndistinct_elts} "):
        if rc != 0 or field not in header:
            raise AssertionError(f"cli.cqf_dump --meta-only lacks {field!r}")
    print(f"  cli.cqf_dump --meta-only agrees with the .ser header; "
          f"cli.minia took {wall:.1f} s")


def main() -> int:
    import torch

    phase0_device()
    sys.path.insert(0, REPO)
    from sh_assembly_tpu_torch.ops import merge_cuda as mc

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        phase1_build()
        dev = torch.device("cuda", 0)
        err, timing = phase2_k1(dev)
        phase3_parity()
        phase4_main()
        err2, err3, timing5 = phase5_k2_k3(dev)
        phase6_pipeline_parity()
        launches = phase7_genome()
        err4, launches["block_sort"], timing["block_sort"] = phase8_k4(dev)
        phase9_library(dev)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    loaded = [m for m in sys.modules
              if m == "sh_assembly_tpu" or m.startswith("sh_assembly_tpu.")]
    if loaded:
        raise AssertionError(f"JAX package modules loaded: {loaded}")
    timing.update(timing5)
    ops = "sh_assembly_tpu/ops/"
    pipeline, prof = "phase 7 (cli.pipeline)", \
        "phase 8 (profile.blocksort.main); the main path: 0"
    rows = [("merge_dedup", "merge", ops + "merge_pallas.py:524", err,
             pipeline),
            ("count_join", "count_join", ops + "join_pallas.py:257", err2,
             pipeline),
            ("merge128", "merge128", ops + "merge128_pallas.py:284", err3,
             pipeline),
            ("block_sort", "block_sort", "profile_blocksort.py:63", err4,
             prof)]
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"sh_assembly_tpu_torch/csrc/{name}.cu",
        "replaces": where, "launches": launches[name],
        "launches_in": path, "max_abs_err": e, **timing[t]}
        for name, t, where, e, path in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.modules["jax"] = None  # the port runs without JAX: make sure of it
    sys.exit(main())
