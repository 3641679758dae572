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
     merge; a chain of folds on one reused pair of buffers (merge, merge,
     a sweep that shrinks the store, merge, an overflow, a merge after
     it), the whole capacity compared after every step; an output whose
     clean part is poisoned, which must come back untouched; and one
     merge and one sweep at the counting stage's real size (~100 M live
     entries, a full 2^27 buffer, key_bits 37, 2^29 slots) into a reused
     output, as the store calls them, timed against the twin.
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
     entries, sentinels, tiles of queries whose store range is wide,
     empty or ends on a tile boundary, duplicate queries, tensors that are
     not 16-byte aligned, k = 62 poly-T k-mers, an overflowing fold;
     for K3 also a stream of nothing but sentinels, of one k-mer, runs of
     one k-mer across several tiles with the seeded copy in either
     stream, views at odd offsets, a flush at a small size (30 copies a
     k-mer, a long sentinel tail) and a chain of folds on one store
     (growing, resting, overflowing); and calls at the main path's real shapes (9 x 2^24 probes against phase 2's
     100 M-entry store, and 2^22 probes, a sparse shape, beside them; for
     K3 the shape a flush hands it, a 12.1 M-entry node store against
     59.8 M sorted candidates, the same candidates against an empty
     store, and a small shape of 2^22 candidates), timed against the
     plain versions; then the profiling entry point for all four kernels
     (profile.kernels.main), which times the wrappers and each of their
     kernels by name.
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
     bitwise: windows of 2^7 to 2^19 values (several windows in a block,
     one window in a block, in a cluster of two and of four blocks, and
     above the cluster's reach), several each and once more windows than
     clusters fit on the card, with random values over the whole u32
     range, all equal, sorted, reversed and only 0 and 0xFFFFFFFF; then
     the profiling entry point
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
HBM_BYTES_PER_S and the key comparisons over OPS_PER_S; K2's entry also
has its time at the sparse shape (sparse_ms) beside torch.searchsorted's
there (sparse_library_ms), K3's its times at the small shape (small_ms)
and against an empty store (empty_ms, empty_bound_ms).  Work files go to
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
        if name == "tiles_hot_drop0":
            # views that start 8 bytes into their tensors: no 16-byte
            # alignment
            yield ("unaligned_views", s.store[1:], buf[1:], s.n_main - 1, kb,
                   drop, C)
        if not drop and name.startswith("case"):
            # the sweep of the same store: K1 with an empty buffer
            yield name + "_sweep", s.store, buf[:0], s.n_main, kb, True, C


K1_CHAIN = dict(key_bits=30, capacity=40_000)


def k1_chain(device, merge, reuse: bool, seed=31):
    """A chain of folds on one store through ``merge`` (K1's wrapper or its
    plain twin): merge, merge, a sweep that shrinks the store, merge, an
    overflowing merge, a sweeping merge after it.  With ``reuse`` each
    fold writes into the buffer the fold before read, as ``spectrum._fold``
    does; without, into a fresh tensor.  Yields (name, the whole output,
    n_live, n_dropped) after every step."""
    import torch

    from sh_assembly_tpu_torch.ops import spectrum as sp

    kb, C = K1_CHAIN["key_bits"], K1_CHAIN["capacity"]
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 1 << kb, size=30_000, dtype=np.uint64)

    def block(n):
        keys = rng.choice(pool, size=n)
        keys[rng.random(n) < 0.1] = _SENT64
        return keys

    steps = [("merge1", block(20_000), False),
             ("merge2", block(20_000), False),
             ("sweep", np.empty(0, np.uint64), True),
             ("merge3", block(10_000), False),
             ("overflow", rng.integers(0, 1 << kb, size=40_000,
                                       dtype=np.uint64), False),
             ("merge_after_overflow", block(5_000), True)]
    store = torch.full((C,), -1, dtype=torch.int64, device=device)
    spare, dirty, n_main = torch.full_like(store, -1), 0, 0
    for name, keys, drop in steps:
        buf = sp.sort_pack_buf(
            torch.from_numpy(keys.view(np.int64)).to(device), kb)
        into = dict(out=spare, out_dirty=dirty) if reuse else {}
        out, n_live, n_drop = merge(store, buf, n_main, kb, drop, C, **into)
        yield name, out.clone(), int(n_live), int(n_drop)
        spare, dirty = store, n_main
        store, n_main = out, min(int(n_live), C)


K1_POISON = 0x5A5A5A5A5A5A5A5A


def k1_poisoned_output(device, merge):
    """Merges into an output that holds poison where the caller promises
    sentinels, once with ``out_dirty`` below the merge's n_live and once
    above it: the merge must write live entries, then sentinels up to
    ``out_dirty``, and nothing behind.  Raises if it does."""
    import torch

    _, main, buf, n_main, kb, drop, C = next(
        c for c in k1_cases(device) if c[0] == "case0_kb33")
    want, n_live, _ = merge(main, buf, n_main, kb, drop, C)
    n_live = int(n_live)
    for out_dirty in (n_live // 2, C - 10):
        out = torch.full((C,), K1_POISON, dtype=torch.int64, device=device)
        got, n_got, _ = merge(main, buf, n_main, kb, drop, C, out=out,
                              out_dirty=out_dirty)
        clean = max(n_live, out_dirty)
        if not (got is out and int(n_got) == n_live < C - 10
                and torch.equal(out[:clean], want[:clean])
                and bool((out[clean:] == K1_POISON).all())):
            raise AssertionError(
                f"merge with out_dirty={out_dirty}, n_live={n_live}: wrong "
                f"entries, or words written at or beyond the clean extent")


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
    # few queries against a wide store: a tile's range does not fit in
    # shared memory and is searched in device memory
    yield ("wide_range", *case(7, 37, 300_000, 5000))
    # tiles whose queries all lie above the last stored key: empty ranges
    rng = np.random.default_rng(8)
    keys = np.unique(rng.integers(0, 1 << 20, size=3000, dtype=np.uint64))
    s = spectrum(keys, rng.integers(1, 200, size=len(keys)), None, 30)
    q = np.sort(np.concatenate([
        rng.choice(keys, size=3000),
        rng.integers(1 << 21, 1 << 30, size=9000, dtype=np.uint64)]))
    yield ("empty_ranges", s.store, s.n_main, bits.from_u64_np(q, device), 30)
    # every stored key queried once, then four times: whatever the tile
    # size, tiles end on the store word the next tile starts with
    keys = np.arange(20_000, dtype=np.uint64) * np.uint64(3)
    s = spectrum(keys, rng.integers(1, 200, size=len(keys)), None, 30)
    for rep in (1, 4):
        yield (f"range_on_tile_boundary_x{rep}", s.store, s.n_main,
               bits.from_u64_np(np.repeat(keys, rep), device), 30)
    # one stored key and one absent key, 10,000 times each
    q = np.repeat(np.array([3000, 3001], np.uint64), 10_000)
    yield ("all_duplicates", s.store, s.n_main, bits.from_u64_np(q, device),
           30)
    # views that start 8 bytes into their tensors: no 16-byte alignment
    store, n_main, q, kb = case(9, 37, 50_000, 70_000)
    yield ("unaligned_views", store[1:], n_main - 1, q[1:], kb)


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

    # a stream b of nothing but sentinels; of nothing but one k-mer, stored
    # (unseeded) or not, one copy in b seeded
    yield case("b_all_sentinels", 11, 47, 3000, 0, 0.0, pad=5000)
    rng = np.random.default_rng(12)
    hi, lo = _rand_kmers(rng, 3001, 47)
    for label, x in (("stored", 1500), ("new", 3000)):
        seed = np.zeros(10_000, bool)
        seed[7777] = True
        a_s = _k3_stream(device, hi[:3000], lo[:3000], np.zeros(3000, bool),
                         64)
        b_s = _k3_stream(device, np.full(10_000, hi[x]),
                         np.full(10_000, lo[x]), seed, 100)
        yield (f"b_one_kmer_{label}", *a_s, 3000, *b_s, 3064)
    # one k-mer's run across several tiles and across both streams, the
    # only seeded copy in a or in b
    for where in ("a", "b"):
        a_hi = np.concatenate([hi[:500], np.full(4000, hi[700])])
        a_lo = np.concatenate([lo[:500], np.full(4000, lo[700])])
        b_hi = np.concatenate([hi[400:900], np.full(6000, hi[700])])
        b_lo = np.concatenate([lo[400:900], np.full(6000, lo[700])])
        a_seed, b_seed = np.zeros(4500, bool), np.zeros(6500, bool)
        (a_seed if where == "a" else b_seed)[-1] = True
        a_s = _k3_stream(device, a_hi, a_lo, a_seed, 100)
        b_s = _k3_stream(device, b_hi, b_lo, b_seed, 300)
        yield (f"run_across_tiles_seed_in_{where}", *a_s, 4500, *b_s, 6000)
    # views that start one entry into their tensors: hi and lo 8 bytes,
    # the flags 1 byte off any wider alignment
    name, ah, al, af, na, bh, bl, bf, cap = case("unaligned_views", 13, 47,
                                                 30_000, 50_000, 0.5,
                                                 pad=3000, rep=3)
    yield (name, ah[1:], al[1:], af[1:], na - 1, bh[1:], bl[1:], bf[1:],
           cap)
    # a flush at a small size: 30 copies of every distinct k-mer, most of
    # them stored already, a sentinel tail of a fifth of the stream
    from sh_assembly_tpu_torch.profile import kernels as pk

    yield ("flush_30x", *pk.k3_flush_case(
        device, n_store=20_000, cap=1 << 15, n_b=100_000, n_solid=81_000,
        n_distinct=2_700, n_hit=2_400))


K3_CHAIN = dict(k=47, capacity=30_000)


def k3_chain(device, merge, seed=33):
    """A chain of folds on one node store through ``merge`` (K3's wrapper
    or its plain version): the first into an empty store, two that grow
    it, one with next to nothing new, one that overflows it, one after the
    overflow.  Yields (name, the whole (hi, lo, nflag) output, n_live)
    after every step."""
    import torch

    cap = K3_CHAIN["capacity"]
    rng = np.random.default_rng(seed)
    hi, lo = _rand_kmers(rng, 60_000, K3_CHAIN["k"])

    def block(n, pool, pad):
        pick = rng.integers(0, pool, size=n)
        return _k3_stream(device, hi[pick], lo[pick], rng.random(n) < 0.05,
                          pad)

    steps = [("first", block(30_000, 8_000, 4_000)),
             ("grow1", block(30_000, 12_000, 100)),
             ("grow2", block(20_000, 20_000, 9_000)),
             ("few_news", block(5_000, 8_000, 0)),
             ("overflow", block(40_000, 60_000, 500)),
             ("after_overflow", block(3_000, 60_000, 7))]
    store = (torch.full((cap,), -1, dtype=torch.int64, device=device),
             torch.full((cap,), -1, dtype=torch.int64, device=device),
             torch.ones(cap, dtype=torch.uint8, device=device))
    n = 0
    for name, b in steps:
        *out, n_live = merge(*store, n, *b, cap)
        yield name, tuple(out), int(n_live)
        store, n = tuple(out), min(int(n_live), cap)


def k4_cases(device):
    """(name, x, W) tuples for K4: int32 tensors carrying u32 patterns,
    made from numpy seeds.  The window counts leave a ragged last block
    where the window is below the 2^15 words a block holds; windows of
    2^15 fill a block, of 2^16 and 2^17 a cluster of two and four, and
    larger ones also take passes over device memory; 35 windows of 2^17
    are more clusters than an H100 holds at once."""
    import torch

    for log2_w, g in ((7, 5), (7, 200), (10, 7), (10, 19), (13, 1), (13, 5),
                      (15, 3), (17, 2), (16, 3), (18, 3), (19, 2),
                      (17, 35)):
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
    from sh_assembly_tpu_torch.profile import kernels as pk

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

    # folds chained on one reused pair of buffers against the twin writing
    # fresh tensors: the whole capacity, so the tail's bookkeeping too
    counts = []
    for (name, *kern), (_, *plain) in zip(
            k1_chain(device, mc.merge_dedup_cuda, reuse=True),
            k1_chain(device, mc.merge_dedup_plain, reuse=False)):
        err = max(err, _compare(f"chain {name}", kern, plain))
        counts.append(kern[1])
        print(f"  chain {name}: n_live={kern[1]} n_dropped={kern[2]} "
              f"identical over all {K1_CHAIN['capacity']} slots")
    if not (counts[2] < counts[1] and counts[4] > K1_CHAIN["capacity"]
            and counts[5] <= K1_CHAIN["capacity"]):
        raise AssertionError(f"the chain does not shrink, overflow and "
                             f"recover: {counts}")
    k1_poisoned_output(device, mc.merge_dedup_cuda)
    print("  poisoned output: nothing written at or beyond the clean extent")

    store, buf, n, kb, C = pk.big_case(device)
    nb_live = int((buf != -1).sum())
    print(f"  real size: n_main={n} buf={buf.numel()} ({nb_live} live) "
          f"key_bits={kb} capacity={C}", flush=True)
    timing = {}
    out = torch.full((C,), -1, dtype=torch.int64, device=device)
    held = 0  # out is all sentinel from here on
    for label, b, drop in (("merge", buf, False), ("sweep", buf[:0], True)):
        # into a reused output that last held the store's n entries or
        # more, as spectrum._fold hands it in
        def into_reused():
            return mc.merge_dedup_cuda(store, b, n, kb, drop, C, out=out,
                                       out_dirty=max(held, n))

        kern = into_reused()
        plain = mc.merge_dedup_plain(store, b, n, kb, drop, C)
        err = max(err, _compare(f"real-size {label}", kern, plain))
        held = n_live = int(kern[1])
        n_drop = int(kern[2])
        del kern, plain
        ms = _time_ms(into_reused, 7)
        fresh_ms = _time_ms(
            lambda: mc.merge_dedup_cuda(store, b, n, kb, drop, C), 7)
        plain_ms = _time_ms(
            lambda: mc.merge_dedup_plain(store, b, n, kb, drop, C), 3)
        # the bound: the live store and the buffer read and the live
        # result written, one key comparison for each word read.  What K1
        # moves: the buffer's sentinel tail left out, and the part of the
        # output that was dirty behind the live result filled
        live_b = nb_live if b.numel() else 0
        moved = (n + b.numel() + n_live) * 8
        whole = (n + live_b + max(n_live, n)) * 8
        timing[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                             **bound(moved, n + b.numel()))
        print(f"  real-size {label}: n_live={n_live} n_dropped={n_drop} "
              f"identical; K1 median {ms:.3f} ms into a reused output "
              f"({fresh_ms:.3f} ms into a fresh tensor, all {C} slots "
              f"written), plain twin median {plain_ms:.3f} ms; K1 moves "
              f"{whole / 1e9:.2f} GB -> {whole / ms / 1e6:.1f} GB/s; bound "
              f"{timing[label]['bound_ms']:.3f} ms for the {moved / 1e9:.2f} "
              f"GB of the live result")
    del store, buf, out
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
    from sh_assembly_tpu_torch.profile import kernels as pk

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
    store, _, n, kb, C = pk.big_case(device)
    q = pk.probe_keys(store, n, kb, 9 << 24)
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
    del qk
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
    # the sparse shape beside it: 2^22 probes, 24 store words apart
    qs = pk.probe_keys(store, n, kb, 1 << 22)
    err2 = max(err2, _check_k2("sparse shape", jc.count_join_cuda(
        store, n, qs, kb), jc.count_join_plain(store, n, qs, kb)))
    sparse_ms = _time_ms(lambda: jc.count_join_cuda(store, n, qs, kb), 7)
    sparse_lib = _time_ms(lambda: torch.searchsorted(
        skeys, torch.where(qs == -1, 0, qs)), 3)
    timing["count_join"].update(sparse_ms=sparse_ms,
                                sparse_library_ms=sparse_lib)
    print(f"  K2 sparse shape ({qs.numel()} queries) identical; K2 median "
          f"{sparse_ms:.3f} ms, torch.searchsorted (with the query "
          f"clean-up) {sparse_lib:.3f} ms")
    del store, q, qs, skeys
    torch.cuda.empty_cache()

    # a chain of folds on one store against the plain version: the whole
    # capacity after every step
    counts = []
    for (name, kern, nk), (_, plain, np_) in zip(
            k3_chain(device, m3.merge128_cuda),
            k3_chain(device, m3.merge128_plain)):
        err3 = max(err3, _check_k3(f"chain {name}", (*kern, nk),
                                   (*plain, np_)))
        counts.append(nk)
        print(f"  K3 chain {name}: n_live={nk} identical over all "
              f"{K3_CHAIN['capacity']} slots")
    if not (counts[0] < counts[1] < counts[2] <= counts[3] < counts[2] + 100
            and counts[4] > K3_CHAIN["capacity"]):
        raise AssertionError(f"the K3 chain does not grow, rest and "
                             f"overflow: {counts}")

    # K3 at the shape a flush hands it; against an empty store; at the
    # small shape
    flush = pk.k3_flush_case(device)
    cap = flush[-1]
    nb_live = int(((flush[4] != -1) | (flush[5] != -1)).sum())
    for label, args in (("flush shape", flush),
                        ("empty store", (*flush[:3], 0, *flush[4:]))):
        na = args[3]
        print(f"  K3 {label}: na={na} cap={cap} nb={args[4].numel()} "
              f"({nb_live} before the sentinel tail)", flush=True)
        kern = m3.merge128_cuda(*args)
        torch.cuda.synchronize()
        t0 = time.time()
        plain = m3.merge128_plain(*args)
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3  # once: three sorts of 72 M
        err3 = max(err3, _check_k3(label, kern, plain))
        n_live = int(kern[3])
        del kern, plain
        ms = _time_ms(lambda: m3.merge128_cuda(*args), 7)
        # 17 B an entry (hi, lo, flag): the live store and the candidates
        # before the stream's sentinel tail read, the live result written
        # (as for K1, not the output's sentinel tail).  The tail is found
        # by a search and is no part of the function's work.  Two word
        # comparisons for each entry read
        n_in = na + nb_live
        moved = (n_in + n_live) * 17
        t = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                 **bound(moved, 2 * n_in))
        if label == "flush shape":
            timing["merge128"] = t
        else:
            timing["merge128"].update(empty_ms=ms,
                                      empty_bound_ms=t["bound_ms"])
        print(f"  K3 {label}: n_live={n_live} identical; K3 median {ms:.3f} "
              f"ms, plain version {plain_ms:.3f} ms (one call); bound "
              f"{t['bound_ms']:.3f} ms for {moved / 1e9:.2f} GB (the store, "
              f"the candidates before the tail, the live result) -> "
              f"{moved / ms / 1e6:.1f} GB/s")
    del flush, args
    torch.cuda.empty_cache()
    args = pk.k3_big_case(device)
    kern = m3.merge128_cuda(*args)
    err3 = max(err3, _check_k3("small shape", kern, m3.merge128_plain(*args)))
    n_live = int(kern[3])
    del kern
    small_ms = _time_ms(lambda: m3.merge128_cuda(*args), 7)
    small_plain = _time_ms(lambda: m3.merge128_plain(*args), 3)
    moved = (args[3] + args[4].numel() + n_live) * 17
    timing["merge128"].update(small_ms=small_ms, small_plain_ms=small_plain,
                              small_bound_ms=bound_ms(moved))
    print(f"  K3 small shape: na={args[3]} nb={args[4].numel()} "
          f"n_live={n_live} identical; K3 median {small_ms:.3f} ms, "
          f"plain median {small_plain:.3f} ms; bound "
          f"{bound_ms(moved):.3f} ms for {moved / 1e9:.2f} GB")
    del args
    torch.cuda.empty_cache()

    # the profiling entry point for the four kernels, as a user runs it:
    # the wrappers' medians and each kernel's device time by name
    rc, logtxt, wall = _run_main(pk.main, [])
    rows = [ln.split("] ", 1)[-1] for ln in logtxt.splitlines()
            if " ms" in ln]
    if rc != 0 or len(rows) != 16 or not all(
            k in logtxt for k in ("k_merge", "k_join_tiles", "k_sort")):
        raise AssertionError("profile.kernels did not time every row")
    print(f"  profile.kernels ({wall:.1f} s):")
    for ln in rows:
        print(f"    {ln}")
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
    print(f"  {n} cases (windows 2^7..2^19; random, equal, sorted, reversed, "
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
