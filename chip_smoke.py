#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sh_assembly_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits non-zero without printing a result:

  0. device: nvidia-smi name and power limit, torch/CUDA versions; no GPU
     is an error.
  1. build: compiles kernels K1-K11 (csrc/merge_dedup.cu, count_join.cu,
     merge128.cu, block_sort.cu, hash_append.cu, stage_windows.cu,
     node_join.cu, node_probes.cu, contract.cu, members.cu, path_stats.cu;
     hash_append and stage_windows include
     csrc/tile_scan.cuh) from the checkout, one nvcc each, in parallel;
     prints K5's and K6's tiles at their real shapes and for rows of
     20,000 bases (rows or segments a block, shared memory, registers,
     spills, blocks an SM).
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
     synthetic reads; counts K1 and K5 launches (K5 appends a stack of 8
     batches a launch: fewer launches and append calls than batches),
     checks the .ser header, reports k-mers/s and peak device memory.
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
     contigs.fa must be byte-identical, the CUDA run must launch every
     kernel of the path (K1-K3, K5-K11) and the CPU run none; then the
     Contiger CLI with --device cuda on the CPU run's .ser, whose
     unitigs.fa must equal the CPU pipeline's and which must launch K2,
     K3 and K6-K11.
  7. main path at real size: the pipeline CLI on a 12 Mbp genome (30x of
     150 bp reads); prints the phase breakdown, peak device memory, node,
     unitig and contig counts and N50; the contigs must total within 10%
     of the genome, every kernel of the path (K1, K2, K3, K5-K11) must
     launch, K5 by the stack (fewer launches and append calls than
     batches), K6 once a ``_stage_super`` call with no call of its plain
     chain, K8 once a call of the probe programs (``phantom_candidates``,
     ``build_oriented_graph``), K7 through one table for the run (a build,
     an append a closure round that found phantoms, a probe a round and
     one for the graph) with no one-shot ``join2``, no call of
     ``node_probes_plain`` or ``join2_plain``, the contraction through
     K9 (its three calls), the members step through K10 (one
     placement), the medians through K11 and the link join through a K7
     table of its own (a build and a probe, once each); prints every K7
     call's device time; then replays the
     closure and the graph probe on the run's inputs and holds every
     probe of the table against ``join2_plain`` on that round's padded
     store, and runs ``finalize_unitigs`` on the run's own forest moved
     to the CPU (the plain twins), whose unitigs.fa must be the CUDA
     run's, byte for byte.

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
 10. the mesh path, n key-range shards on the card (``parallel/``):
     (a) on phase 3's reads, cqf_denoise --mesh 8 with --device cpu and
     cuda, byte-identical .ser files with a deNoise sweep mid-stream, K1
     and K5 launched on the card only, and contiger --mesh 4 on both
     devices, byte-identical unitigs.fa; (b) phase 4's reads and flags
     through --mesh 8 (2^26 slots a shard), byte-identical to phase 4's
     .ser (no sweep fires mid-stream), rate, wall, peak memory, K1 and K5
     launches, and the buffer sort's bytes a key at its peak;
     (c) phase 7's 12 Mbp genome through cqf_denoise --mesh 4 and contiger
     --mesh 4: the unitigs the same set as phase 7's (cli.compare_contigs)
     and cli.minia's contigs within 10% of the genome, with phase
     breakdowns, peaks and K1-K3 and K5 launches (the mesh's counter
     hashes through K5, one launch a shard a scan), and the mesh's tail
     through K9 (three calls) and K10 (one placement) as the single
     store's; each counting line
     prints count:mesh scan and K5's launches; (d) profile.mesh (routed
     against one shard alone, n = 8) and dryrun_multichip(8).
 11. the multi-process mesh (``collectives.Distributed`` over
     torch.distributed; workers spawned from this file): (a) phase 7's
     reads counted by 2 processes x 2 shards over gloo on the one card,
     each process feeding its half of every global batch through
     ``driver.count_stream``, every shard's whole state bitwise equal to
     the in-process mesh of 4 (``driver.count_sharded``); (b) the
     Contiger's collective steps (``sharded_contiger.shard_parts``) on
     phase 3's reads and phase 10a's .ser at 2 x 2 over gloo, the stores
     and probe parts bitwise equal to the in-process mesh's, and the host
     tail (``finish_parts``) on them in this process byte-identical to
     10a's contiger --mesh 4; (c) the NCCL branch: one process of 4 shards
     counts phase 3's reads and runs (b)'s steps, bitwise as well.  Each
     process's wall, phases, peak memory and kernel launches are printed;
     11a requires K5 launches in its processes and prints count:mesh scan
     beside them, 11b K2, K3 and K6 launches.

 12. the profiling entry points of the counting hot path and the Contiger
     at their defaults: profile.entry (one fused counting step,
     counter.count_batch), profile.hot (hash, the stack's append through
     K5, the buffer sorts and K1 at 2^28 slots),
     profile.collect (node collection under cProfile, with its device
     share) and profile.stage2 (graph probes and contraction of 2^24
     nodes against a 2^28-slot spectrum), each printing what it measured
     and its kernel launches; profile.collect must launch K6.
 13. the bench (``python -m sh_assembly_tpu_torch.bench``) at its default
     shapes with SH_BENCH_FULL=1, in this process after phase 12 (the
     kernels are built): it must exit 0 with the primary JSON line last
     (at least 2 merges in its timed window) and a warm end-to-end line
     before it, K1 bitwise equal to its plain twin, no section skipped
     for the deadline, K6 launched (its stage-2 collect and staging rate);
     prints its JSON and ``#`` lines, the loaded-counting windows and the
     kernel launches of the whole run.
 14. K5 (hash + append) against its plain PyTorch version on the card,
     bitwise, words around the written range included: the cases of the
     CPU test (tests/test_torch_append_scan.py: k = 21, 47, 63, Ns, rows
     shorter than k, zero-length rows, an odd starting fill) in both
     input forms (base codes and the 2-bit transport), batches of 100
     rows, rows of 37, 152 and 5000 bases, batches of nothing but empty
     or short rows; the redesign's edges (k5_edge_cases): rows of 64, 65
     and 160 bases (the rotations wrap), k = 1 and k = 63 on rows of 63,
     rows of 20,000 bases cut into segments with Ns on every seam, rows
     of length 0, below k and ending on a seam; then its two real shapes,
     profile.hot's (8 x 8192 reads of 160 bp, k = 47, key_bits 36) and
     phase 7's (150 bp reads in rows of 152, key_bits 34), timed against
     the plain version with their bounds: the kernel's device time (20
     launches queued behind a spin kernel, timed back to back by CUDA
     events) and a wrapper call's (CUDA events around one call, the
     host's launch path included).
 15. K6 (collect staging) against its plain PyTorch version on the card,
     bitwise, entries around the written range included: every k of the
     CPU test (tests/test_torch_stage.py: 21, 31, 32, 33, 47, 63) on rows
     of 72 and 160 with Ns, pad, empty and short rows and seed columns in
     and out of range, under both key rules at odd offsets; its tiling's
     edges (k6_edge_cases): k = 1 and 63 on rows of 64, rows of 8 bases,
     2000 rows of 152, rows of nothing but empty or short rows, rows of
     20,000 bases in segments with Ns and seed columns on the seams; then
     its two real shapes, phase 7's stack (8 x 8192 reads of 150 bp in
     rows of 152, k = 47, key_bits 34) and the bench's stage-2 stack (rows
     of 160, key_bits 33), timed as phase 14 times K5, beside the bound,
     the plain chain and a fill of the four outputs.
 16. K7 (node join) and K8 (node probes) against ``join2_plain`` and
     ``node_probes_plain`` on the card, bitwise: K7 on a table of one pair
     repeated, the closure's padded store (sentinel pad rows, sentinel
     queries), N and Q not powers of two, Q = 0, N = 1, N = 0, tables in
     random order with repeats and sentinels at k = 21, 31, 32, 33, 47,
     63, warps holding several groups of equal pairs, and 2^20 rows
     against 3 x 2^20 queries; K7's table grown as the closure grows its
     store (appends inside the padded extent, filling it exactly,
     crossing it, full at the first build, repeated rows, sentinel
     queries), every step against join2_plain on the padded rows; K8 at
     k = 1 and those k in both modes with padding rows; then both at their
     real shapes, timed as phase 14 times K5 beside the bound and the
     plain version: profile.stage2's 2^24 node k-mers (K8 graph mode, K7
     with their 8 x 2^24 successors) and phase 7's padded store
     (12,232,221 nodes, sentinel pad to 2^24: K8 closure mode, K7 with the
     16 x 2^24 probes of closure round 1), K7 also as a build and a probe
     apart; K7 at two later closure rounds (5,000 and
     50,000 phantoms appended, the probes of a frontier padded to 2^14
     and 2^22) and the graph's probe of phase 7's store with the
     closure's table; and the split of one build_oriented_graph call at
     2^24 nodes against profile.stage2's spectrum (probes, node join,
     count join with its library sort, the rest), its peak, and one
     closure round.
 17. K9 (contraction) against its plain twins (``rank_plain``,
     ``revcomp_packed``, ``keep_plain``) on the CPU and on the card,
     bitwise: paths, cycles with and without a splitter, padding rows, a
     mirrored forest, cycles only, no edge, M = 2, k = 21 to 63, one path
     of 2^20 oriented nodes beside 2^12 cycles (``k9_cases``); then at
     the E. coli cell's oriented extent (2^24, K9_SHAPE), timed as phase
     14 times K5 beside the bound and the plain twins on the card.
 18. K10 (the members of kept paths) against its plain twin on the CPU
     and on the card, bitwise: ``k10_cases`` at k = 21, 31, 47 and 63
     (paths, cycles, padding rows, a mirrored forest with palindromic
     heads, cycles only, padding rows alone, M = 2), a padding row forged
     onto a kept path (refused); then at phase 17's extent (2^24 oriented
     nodes), timed as phase 14 times K5 beside the bound and the plain
     twin on the card, with its launches on phase 7's main path.
 19. K11 (each kept path's median, count sum and seed flag) and the link
     join through K7 against their plain twins on the CPU and on the card,
     bitwise: ``k11_cases`` (paths of one member, every length a warp
     takes, lengths around the warp's and the block's limits and far
     beyond, counts up to and at the cap, equal counts, even paths of two
     values, no seed mask, no path) and ``links_cases`` (the ends of
     pieces of a genome at k = 21-63 with reversed pieces, siblings,
     palindromic paths and repeated keys, one path, none); then both at
     phase 17's extent (K10's members of its forest) and at the yeast
     cell's (``YEAST_PATHS``), timed as phase 14 times K5 beside their
     bounds and the plain twins on the card, with their launches on
     phase 7's main path.

``python3 chip_smoke.py --nccl-processes N`` runs phases 0, 1 and 11a
alone at N processes x 1 shard over NCCL, a card each (N cards).

The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels, and the one before that repeats phase 0's card name and power
limit.  The kernels line gives launches on the path that runs each (phase
7 for K1-K3 and K5-K8, phase 8's profiling entry point for K4, which the
main path never launches), launches on the mesh path (phase 10c), launches
summed over the processes of the multi-process path (mp_launches: 11a for
K1 and K5, 11b for K2, K3, K6, K7 and K8), launches in the bench
(bench_launches, phase 13), times (K9's at phase 17's cell extent, with
its parts; K10's at the same extent, phase 18; K5's at profile.hot's
shape, genome_*
at phase 7's; K6's at phase 7's, stage2_* at the bench's; K7's and K8's at
the graph shape of phase 16, closure_* at its closure shape, K7's later_*
at its later closure round of a 2^14 frontier (an append and a probe),
*_build_ms and *_probe_ms its two parts and main_graph_probe_ms the
graph's probe of phase 7's store; K5-K8's ms is device time, wrapper_ms
a wrapper call's), and each
kernel's bound, the least time the card could
take, computed from this run's shapes and results: the larger of the
bytes moved (each input read once, the live result written once) over
HBM_BYTES_PER_S and the key comparisons (K5: the 32-bit operations of a
rolling hash; K6: those and two rolled 128-bit words; K7: ten a row and a
query; K8: four 64-bit ones a base and 24 a probe) over OPS_PER_S; K2's
entry also has its time at the sparse shape (sparse_ms) beside torch.searchsorted's
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
from typing import NamedTuple

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


# K5's geometries of the CPU test (tests/test_torch_append_scan.py):
# (k, key_bits) with key_bits below, at and above one 32-bit plane
K5_GEOMETRIES = [(21, 22), (47, 32), (63, 56)]


def k5_stack(seed: int, k: int, S: int = 3, B: int = 5, L: int = 72):
    """u8 base codes [S, B, L] and int32 lengths [S, B] from a numpy seed:
    Ns (code 4) and pad bases (code 5) inside reads, full rows, a
    zero-length row, a row one base shorter than k, a row of exactly k,
    and pad behind every length."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(S, B, L)).astype(np.uint8)
    odd = rng.random((S, B, L))
    codes[odd < 0.03] = 4
    codes[odd > 0.99] = 5
    lengths = rng.integers(k, L + 1, size=(S, B)).astype(np.int32)
    lengths.flat[0] = 0
    lengths.flat[min(B + 1, lengths.size - 1)] = k - 1
    lengths.flat[-1] = L
    lengths.flat[min(B + 3, lengths.size - 2)] = k
    codes[np.arange(L)[None, None, :] >= lengths[..., None]] = 5
    return codes, lengths


def k5_forms(device, codes, lengths):
    """(form, bases, lengths) of one stack on device: the base codes, and
    the 2-bit transport where rows are a multiple of 8 bases."""
    import torch

    from sh_assembly_tpu_torch.ops import packio

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    yield "codes", dict(codes=t(codes)), t(lengths)
    if codes.shape[-1] % 8 == 0:
        packed, nmask = packio.pack_np(codes)
        yield "packed", dict(packed=t(packed), nmask=t(nmask)), t(lengths)


def k5_cases(device):
    """(name, bases, lengths, k, key_bits, n_buf) tuples for K5: ``bases``
    is dict(codes=...) or dict(packed=..., nmask=...) of tensors on
    device.  The CPU test's stacks and batches in both forms at an odd
    starting fill, then 8 batches of 100 rows, rows of 152 bases (phase
    7's), rows of 5000 (two segments a row), a batch of nothing but
    zero-length rows and one of rows too short for any window, then
    k5_edge_cases."""
    for k, kb in K5_GEOMETRIES:
        codes, lengths = k5_stack(200 + k, k)
        for form, bases, ln in k5_forms(device, codes, lengths):
            yield f"k{k}_stack_{form}", bases, ln, k, kb, 3
            one = {n: v[1] for n, v in bases.items()}
            yield f"k{k}_batch_{form}", one, ln[1], k, kb, 1001
    for name, seed, k, (S, B, L) in (("rows100", 5, 31, (8, 100, 96)),
                                      ("rows152", 6, 47, (2, 64, 152)),
                                      ("rows5000", 7, 63, (1, 3, 5000)),
                                      ("odd_len", 8, 25, (2, 7, 37))):
        codes, lengths = k5_stack(seed, k, S, B, L)
        for form, bases, ln in k5_forms(device, codes, lengths):
            yield f"{name}_{form}", bases, ln, k, 36, 7
    codes, lengths = k5_stack(9, 47, 1, 16, 64)
    for fill, name in ((0, "all_empty"), (46, "all_short")):
        for form, bases, ln in k5_forms(device, codes,
                                        np.full_like(lengths, fill)):
            yield f"{name}_{form}", bases, ln, 47, 36, 0
    yield from k5_edge_cases(device)


# Rows of K5's edge cases longer than one block's tile
K5_LONG_ROW = 20_000


def k5_edge_cases(device):
    """k5_cases' tuples at the edges of K5's tiling: rows of 64, 65 and 160
    bases (rotations by i mod 64 wrap), k = 1 and k = 63 on rows of 63
    (one window a row), and rows of K5_LONG_ROW bases, which the kernel
    cuts into segments (``hash_append_cuda.plan``): Ns on both sides of
    every seam and of every segment's overlap, and rows of length 0, k - 1,
    ending one base past a seam's overlap, and full."""
    from sh_assembly_tpu_torch.ops import hash_append_cuda as ha

    for name, seed, k, (S, B, L) in (("L64", 11, 31, (2, 40, 64)),
                                      ("L65", 12, 33, (2, 40, 65)),
                                      ("L160", 13, 47, (2, 40, 160)),
                                      ("k1_L63", 14, 1, (2, 30, 63)),
                                      ("k63_L63", 15, 63, (2, 30, 63))):
        codes, lengths = k5_stack(seed, k, S, B, L)
        for form, bases, ln in k5_forms(device, codes, lengths):
            yield f"{name}_{form}", bases, ln, k, 36, 3
    for k in (47, 63):
        L = K5_LONG_ROW
        p = ha.plan(5, L, k)
        sw = p["segment_windows"]
        if p["segments_per_row"] < 2:
            raise AssertionError(f"rows of {L} bases fit one tile: {p}")
        codes, _ = k5_stack(16 + k, k, 1, 5, L)
        lengths = np.array([[L, 0, k - 1, sw + k, L - 3]], np.int32)
        codes[np.arange(L)[None, None, :] >= lengths[..., None]] = 5
        for seam in range(sw, L - k + 1, sw):
            for j in (seam - 1, seam, seam + k - 2, seam + k - 1):
                codes[0, [0, 4], j] = 4
        for form, bases, ln in k5_forms(device, codes, lengths):
            yield f"long{L}_k{k}_{form}", bases, ln, k, 34, 5


def k5_compare(name, bases, ln, k, key_bits, n_buf) -> None:
    """One k5_cases case through K5 and its plain version into two
    buffers poisoned around the written range: both buffers and both
    counts must agree, and the input count must stay as it was."""
    import torch

    from sh_assembly_tpu_torch.ops import hash_append_cuda as ha

    L = bases["codes"].shape[-1] if "codes" in bases else \
        4 * bases["packed"].shape[-1]
    size = n_buf + ln.numel() * (L - k + 1) + 5
    bufs = [torch.full((size,), 0x5A5A5A5A5A5A5A5A, dtype=torch.int64,
                       device=ln.device) for _ in range(2)]
    nelts = torch.full((), 11, dtype=torch.int64, device=ln.device)
    got = ha.hash_append_cuda(bufs[0], n_buf, nelts, ln, k, key_bits, **bases)
    want = ha.hash_append_plain(bufs[1], n_buf, nelts, ln, k, key_bits,
                                **bases)
    torch.cuda.synchronize()
    if int(got) != int(want) or int(nelts) != 11 or not torch.equal(*bufs):
        raise AssertionError(
            f"K5 != plain version on {name}: nelts {int(got)} vs "
            f"{int(want)}, {int((bufs[0] != bufs[1]).sum())} words differ")


def k5_real(device, read_len: int, S: int = 8, B: int = 8192,
            genome_len: int = 8_000_000, seed: int = 1):
    """S batches of B reads of read_len bp from a random genome with N
    bases at 1 in 2000, in the 2-bit transport with rows padded to a
    multiple of 8: (packed, nmask, lengths, Lp) tensors on device."""
    import torch

    from sh_assembly_tpu_torch.ops import packio

    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=genome_len).astype(np.uint8)
    genome[rng.random(genome_len) < 0.0005] = 4
    Lp = (read_len + 7) // 8 * 8
    starts = rng.integers(0, genome_len - read_len, size=(S, B))
    codes = np.full((S, B, Lp), 5, np.uint8)
    codes[..., :read_len] = genome[starts[..., None] + np.arange(read_len)]
    packed, nmask = packio.pack_np(codes)
    lengths = np.full((S, B), read_len, np.int32)
    return (*(torch.from_numpy(a).to(device) for a in
              (packed, nmask, lengths)), Lp)


# K6's geometries: every k the CPU test takes (both word layouts, 2k at,
# below and above 64) on rows of 72 and 160, key_bits below, at and above
# one 32-bit plane
K6_GEOMETRIES = [(k, L, (22, 32, 40)[(i + j) % 3])
                 for i, k in enumerate((21, 31, 32, 33, 47, 63))
                 for j, L in enumerate((72, 160))]


def k6_stack(seed: int, k: int, L: int, R: int = 48):
    """u8 base codes [R, L], int32 lengths and seed columns [R] from a numpy
    seed: Ns at 2 %, pad (code 5) behind every length, rows of length 0,
    k - 1, k and L, and seed columns of -1, the read's middle window, 0,
    the last window, one past it and far out of range."""
    rng = np.random.default_rng(seed)
    W = L - k + 1
    codes = rng.integers(0, 4, size=(R, L)).astype(np.uint8)
    codes[rng.random((R, L)) < 0.02] = 4
    lengths = rng.integers(k, L + 1, size=R).astype(np.int32)
    lengths[:4] = (0, k - 1, k, L)
    codes[np.arange(L)[None, :] >= lengths[:, None]] = 5
    mid = np.maximum(lengths - k, 0) // 2
    choice = rng.integers(0, 6, size=R)
    seed_cols = np.select(
        [choice == 0, choice == 1, choice == 2, choice == 3, choice == 4],
        [np.full(R, -1), mid, np.zeros(R), np.full(R, W - 1), np.full(R, W)],
        np.full(R, 1 << 20)).astype(np.int32)
    seed_cols[4:10] = mid[4:10]  # some seeds inside valid rows for sure
    return codes, lengths, seed_cols


def _k6_case(device, name, codes, lengths, seed_cols, k, key_bits, n, keys):
    import torch

    from sh_assembly_tpu_torch.ops import packio

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    packed, nmask = packio.pack_np(codes)
    return (name, t(packed), t(nmask), t(lengths.astype(np.int32)),
            t(seed_cols.astype(np.int32)), k, key_bits, n, keys)


def k6_cases(device):
    """(name, packed, nmask, lengths, seed_cols, k, key_bits, n, keys) tuples
    for K6, tensors on device: K6_GEOMETRIES at odd offsets under both key
    rules, then k6_edge_cases."""
    for j, (k, L, kb) in enumerate(K6_GEOMETRIES):
        codes, lengths, seed_cols = k6_stack(300 + k + L, k, L)
        keys = ("ok", "valid")[j % 2]
        yield _k6_case(device, f"k{k}_L{L}_kb{kb}_{keys}", codes, lengths,
                       seed_cols, k, kb, 37 + j, keys)
    yield from k6_edge_cases(device)


def k6_edge_cases(device):
    """k6_cases' tuples at the edges of K6's tiling: k = 1 and 63 on rows of
    64 (one and two windows a row), rows of 8 bases at k = 8 (256 rows a
    block), 2000 rows of 152 (many blocks, a partial last one), rows of
    nothing but empty or short rows, and rows of K5_LONG_ROW bases, which
    the kernel cuts into segments (``stage_cuda.plan``): Ns on both sides of
    every seam and of every segment's overlap, seed columns on and beside
    the seams, and rows of length 0, k - 1, ending one base past a seam's
    overlap, and full."""
    from sh_assembly_tpu_torch.ops import stage_cuda as sw_

    for name, seed, k, L, R in (("k1_L64", 21, 1, 64, 40),
                                ("k63_L64", 22, 63, 64, 40),
                                ("k8_L8", 23, 8, 8, 600),
                                ("rows2000_L152", 24, 47, 152, 2000)):
        codes, lengths, seed_cols = k6_stack(seed, k, L, R)
        for keys in ("ok", "valid"):
            yield _k6_case(device, f"{name}_{keys}", codes, lengths,
                           seed_cols, k, 36, 5, keys)
    codes, lengths, seed_cols = k6_stack(25, 47, 64, 16)
    for fill, name in ((0, "all_empty"), (46, "all_short")):
        yield _k6_case(device, name, codes, np.full_like(lengths, fill),
                       seed_cols, 47, 36, 0, "ok")
    for k in (47, 63):
        L = K5_LONG_ROW
        p = sw_.plan(5, L, k)
        sw = p["segment_windows"]
        if p["segments_per_row"] < 2:
            raise AssertionError(f"rows of {L} bases fit one tile: {p}")
        codes, _, _ = k6_stack(26 + k, k, L, 5)
        lengths = np.array([L, 0, k - 1, sw + k, L - 3], np.int32)
        codes[np.arange(L)[None, :] >= lengths[:, None]] = 5
        codes[np.arange(L)[None, :] < lengths[:, None]] = \
            codes[np.arange(L)[None, :] < lengths[:, None]] % 4  # N-free
        for seam in range(sw, L - k + 1, sw):
            for j in (seam - 1, seam, seam + k - 2, seam + k - 1):
                codes[[0, 4], j] = 4
        seed_cols = np.array([sw, sw - 1, 3, sw, 2 * sw + 1], np.int32)
        for keys in ("ok", "valid"):
            yield _k6_case(device, f"long{L}_k{k}_{keys}", codes, lengths,
                           seed_cols, k, 34, 3, keys)


def k6_compare(name, packed, nmask, lengths, seed_cols, k, key_bits, n,
               keys) -> None:
    """One k6_cases case through K6 and its plain version into two sets of
    buffers poisoned around the written range: all four tensors must agree
    word for word, the poison included."""
    import torch

    from sh_assembly_tpu_torch.ops import stage_cuda

    L = 4 * packed.shape[-1]
    size = n + lengths.numel() * max(L - k + 1, 0) + 5
    dev = lengths.device
    outs = []
    for fn in (stage_cuda.stage_windows_cuda, stage_cuda.stage_windows_plain):
        words = [torch.full((size,), 0x5A5A5A5A5A5A5A5A, dtype=torch.int64,
                            device=dev) for _ in range(3)]
        seed = torch.full((size,), 0xA5, dtype=torch.uint8, device=dev)
        m = fn(*words, seed, n, packed, nmask, lengths, seed_cols, k,
               key_bits, keys)
        outs.append((m, words + [seed]))
    torch.cuda.synchronize()
    (mk, got), (mp, want) = outs
    for f, a, b in zip(("hi", "lo", "key", "seed"), got, want):
        if mk != mp or not torch.equal(a, b):
            raise AssertionError(
                f"K6 != plain version on {name}: {f} differs in "
                f"{int((a != b).sum())} entries (wrote {mk} and {mp})")


# ---------------------------------------------------------------------------
# K7 (node join) and K8 (node probes): inputs from numpy seeds

PROBE_KS = (21, 31, 32, 33, 47, 63)  # hi alone up to 32, both words above


def _sentinels(n: int):
    return np.full(n, _SENT64), np.full(n, _SENT64)


def k7_tables(large: bool = False, seed: int = 70):
    """(name, table_hi, table_lo, q_hi, q_lo) numpy uint64 cases of the node
    join: a table of one pair repeated; the closure's padded store (real
    rows, then sentinel pad rows); N and Q that are not powers of two with
    real pairs repeated; Q = 0; N = 1; N = 0; tables in random order with
    repeated pairs and sentinels scattered among them at every k of
    PROBE_KS; warps holding several groups of equal pairs; queries present
    (some many times), absent and sentinel.  ``large`` adds a table of 2^20
    rows, 30 % sentinel pad, against 3 x 2^20 queries."""
    rng = np.random.default_rng(seed)

    def queries(thi, tlo, n_in, n_out, n_sent, k=47):
        pick = rng.integers(0, max(len(thi), 1), n_in if len(thi) else 0)
        ahi, alo = _rand_kmers(rng, n_out, k)
        shi, slo = _sentinels(n_sent)
        qhi = np.concatenate([thi[pick], ahi, shi])
        qlo = np.concatenate([tlo[pick], alo, slo])
        o = rng.permutation(len(qhi))
        return qhi[o], qlo[o]

    def shuffled_table(k, n_distinct, n_repeat, n_sent):
        hi, lo = _rand_kmers(rng, n_distinct, k)
        rep = rng.integers(0, n_distinct, n_repeat)
        shi, slo = _sentinels(n_sent)
        hi = np.concatenate([hi, hi[rep], shi])
        lo = np.concatenate([lo, lo[rep], slo])
        o = rng.permutation(len(hi))
        return hi[o], lo[o]

    h, l = _rand_kmers(rng, 1, 47)
    t = np.repeat(h, 1000), np.repeat(l, 1000)
    yield ("all_duplicates", *t, *queries(*t, 300, 200, 50))
    h, l = _rand_kmers(rng, 5000, 47)
    shi, slo = _sentinels(8192 - 5000)
    t = np.concatenate([h, shi]), np.concatenate([l, slo])
    yield ("sentinel_pads", *t, *queries(*t, 4000, 3000, 500))
    t = shuffled_table(47, 11000, 1345, 0)
    yield ("not_pow2", *t, *queries(*t, 30000, 20000, 4321))
    t = _rand_kmers(rng, 100, 47)
    yield ("q0", *t, *queries(*t, 0, 0, 0))
    t = _rand_kmers(rng, 1, 47)
    yield ("n1", *t, *queries(*t, 500, 500, 0))
    t = _rand_kmers(rng, 0, 47)
    yield ("n0", *t, *queries(*t, 0, 100, 10))
    for k in PROBE_KS:
        t = shuffled_table(k, 3000, 500, 300)
        yield (f"random_order_k{k}", *t, *queries(*t, 4000, 2000, 100, k))
    h, l = _rand_kmers(rng, 5, 63)
    t = h[np.arange(4096) % 5], l[np.arange(4096) % 5]
    yield ("warp_groups", *t, *queries(*t, 3000, 100, 0, 63))
    if large:
        h, l = _rand_kmers(rng, 734_003, 47)
        shi, slo = _sentinels((1 << 20) - len(h))
        t = np.concatenate([h, shi]), np.concatenate([l, slo])
        yield ("pads_2^20", *t, *queries(*t, 1 << 21, (1 << 20) - 1000, 1000))


def k7_cases(device, large: bool = True):
    """k7_tables as int64 tensors on ``device``."""
    from sh_assembly_tpu_torch.ops import bits

    for name, *arrays in k7_tables(large):
        yield (name, *(bits.from_u64_np(a, device) for a in arrays))


def k7_compare(name, thi, tlo, qhi, qlo) -> int:
    """One k7_cases case through K7 and ``join2_plain`` on the card: the
    answers must agree bitwise -> the queries found."""
    import torch

    from sh_assembly_tpu_torch.ops import kmerpack as kp, node_join_cuda

    got = node_join_cuda.node_join(thi, tlo, qhi, qlo)
    want = kp.join2_plain(thi, tlo, qhi, qlo)
    torch.cuda.synchronize()
    if got.dtype != torch.int32 or not torch.equal(got, want):
        raise AssertionError(
            f"K7 != join2_plain on {name}: {int((got != want).sum())} of "
            f"{qhi.numel()} answers differ")
    return int((got >= 0).sum())


def k7_growth(seed: int = 71):
    """(name, hi0, lo0, appends, q_hi, q_lo) numpy uint64 cases of a node
    table grown as the phantom closure grows its padded store
    (``contiger._grow``): hi0/lo0 the real rows of the first build, then
    appends [(hi, lo), ...]: inside the padded extent; filling it exactly
    (no pad row left: a sentinel query answers -1), then crossing it;
    crossing it at once; a store that fills its extent at the first build;
    appended rows that repeat earlier rows and each other.  The queries
    hold rows of every step, absent pairs and the sentinel."""
    rng = np.random.default_rng(seed)

    def grown(name, k, n0, sizes, n_rep):
        hi, lo = _rand_kmers(rng, n0 + sum(sizes), k)
        apps, at = [], n0
        for m in sizes:
            ah, al = hi[at:at + m].copy(), lo[at:at + m].copy()
            # some rows repeat earlier rows, one repeats this append's first
            src = rng.integers(0, at, min(n_rep, m))
            dst = rng.integers(0, m, len(src))
            ah[dst], al[dst] = hi[src], lo[src]
            if m > 2:
                ah[-1], al[-1] = ah[0], al[0]
            hi[at:at + m], lo[at:at + m] = ah, al
            apps.append((ah, al))
            at += m
        pick = rng.integers(0, at, 3 * at // 2)
        ahi, alo = _rand_kmers(rng, at // 2, k)
        shi, slo = _sentinels(97)
        qhi = np.concatenate([hi[pick], ahi, shi])
        qlo = np.concatenate([lo[pick], alo, slo])
        o = rng.permutation(len(qhi))
        return name, hi[:n0], lo[:n0], apps, qhi[o], qlo[o]

    yield grown("appends_k47", 47, 3000, [100, 500, 1, 37], 20)
    yield grown("fills_then_crosses_k47", 47, 1000, [20, 4, 10], 3)
    yield grown("crosses_k21", 21, 4000, [200, 50], 10)
    yield grown("fills_k63", 63, 10, [5, 1000, 9], 2)
    yield grown("full_at_build_k31", 31, 1024, [3, 700], 5)


def k7_grow(device, hi0, lo0, appends, qhi, qlo):
    """Grow a node table on ``device`` as the closure grows its store
    (``contiger._grow``); yields after the build and after each append
    (rows_hi, rows_lo, table, answers): the numpy rows so far, the table
    and its answers to the queries."""
    from sh_assembly_tpu_torch.models import contiger
    from sh_assembly_tpu_torch.ops import bits, node_join_cuda

    def t(a):
        return bits.from_u64_np(a, device)

    q = t(qhi), t(qlo)
    table = node_join_cuda.NodeTable()
    table.build(*contiger._padded(t(hi0), t(lo0)), len(hi0))
    rows_hi, rows_lo = hi0, lo0
    yield rows_hi, rows_lo, table, table.probe(*q)
    for ah, al in appends:
        contiger._grow(table, t(ah), t(al), len(rows_hi))
        rows_hi = np.concatenate([rows_hi, ah])
        rows_lo = np.concatenate([rows_lo, al])
        yield rows_hi, rows_lo, table, table.probe(*q)


def k7_grow_compare(device, name, hi0, lo0, appends, qhi, qlo) -> int:
    """One k7_growth case on the card: after every step the table's store
    is the rows padded anew and its answers are ``join2_plain``'s on it,
    bitwise -> the steps."""
    import torch

    from sh_assembly_tpu_torch.models import contiger
    from sh_assembly_tpu_torch.ops import bits, kmerpack as kp

    steps = 0
    for rows_hi, rows_lo, table, got in k7_grow(device, hi0, lo0, appends,
                                                qhi, qlo):
        ph, pl = contiger._padded(bits.from_u64_np(rows_hi, device),
                                  bits.from_u64_np(rows_lo, device))
        want = kp.join2_plain(ph, pl, bits.from_u64_np(qhi, device),
                              bits.from_u64_np(qlo, device))
        torch.cuda.synchronize()
        if not (torch.equal(table.hi, ph) and torch.equal(table.lo, pl)):
            raise AssertionError(f"{name}, step {steps}: the table's store "
                                 f"is not the padded rows")
        if got.dtype != torch.int32 or not torch.equal(got, want):
            raise AssertionError(
                f"K7 table != join2_plain on {name}, step {steps}: "
                f"{int((got != want).sum())} of {len(qhi)} answers differ")
        steps += 1
    return steps


def k8_nodes(k: int, n: int, seed: int):
    """n packed k-mers as numpy uint64 (hi, lo): random ones, poly-A and
    poly-T, and (-1, -1) padding rows at the start, inside, in a run near
    the end and last."""
    rng = np.random.default_rng(seed)
    hi, lo = _rand_kmers(rng, n, k)
    if n < 8:
        return hi, lo
    ones = (1 << (2 * k)) - 1 << (128 - 2 * k)  # poly-T
    hi[1], lo[1] = 0, 0
    hi[2], lo[2] = ones >> 64, ones & ((1 << 64) - 1)
    for at in (0, 3, n // 2, n - 1):
        hi[at] = lo[at] = _SENT64
    hi[n - 60:n - 20] = lo[n - 60:n - 20] = _SENT64
    return hi, lo


def k8_cases(device):
    """(name, hi, lo, k, key_bits, mode) cases of the node probes: every k
    of PROBE_KS and k = 1, both modes, key_bits 22, 34 and 63, 5003 nodes
    with padding rows; one node; no node."""
    from sh_assembly_tpu_torch.ops import bits

    def case(name, k, n, kb, mode, seed):
        hi, lo = k8_nodes(k, n, seed)
        return (name, bits.from_u64_np(hi, device),
                bits.from_u64_np(lo, device), k, kb, mode)

    for i, k in enumerate((1,) + PROBE_KS):
        for mode in ("graph", "closure"):
            kb = (22, 34, 63)[i % 3]
            yield case(f"k{k}_{mode}_kb{kb}", k, 5003, kb, mode, 80 + k)
    for mode in ("graph", "closure"):
        yield case(f"n1_{mode}", 47, 1, 34, mode, 81)
        yield case(f"n0_{mode}", 47, 0, 34, mode, 82)


def k8_compare(name, hi, lo, k, key_bits, mode) -> None:
    """One k8_cases case through K8 and ``node_probes_plain`` on the card:
    every output row must agree bitwise."""
    import torch

    from sh_assembly_tpu_torch.ops import probe_cuda

    got = probe_cuda.node_probes_cuda(hi, lo, k, key_bits, mode)
    want = probe_cuda.node_probes_plain(hi, lo, k, key_bits, mode)
    torch.cuda.synchronize()
    for f, a, b in zip(("keys", "hi", "lo", "flip"), got, want):
        if (a is None) != (b is None) or (
                a is not None and (a.dtype != b.dtype or a.shape != b.shape
                                   or not torch.equal(a, b))):
            bad = int((a != b).sum()) if a is not None and b is not None \
                and a.shape == b.shape else "all"
            raise AssertionError(f"K8 != node_probes_plain on {name}: {f} "
                                 f"differs in {bad} entries")


def k9_forest(seed: int, n: int, k: int, lens=(1, 40), long_paths=(),
              cycles: int = 0, cycle_lens=(1, 40), pad: float = 0.2,
              mirror: bool = False):
    """A chain forest over the 2n oriented nodes of n node k-mers, as K9
    takes it -> (chain_next int32[2n], hi, lo uint64[n]) numpy.

    A share ``pad`` of the nodes, spread through the store, are (-1, -1)
    padding rows with no edge.  The oriented nodes of the rest, in random
    order (``mirror``: each node in one random orientation, every edge
    a -> b joined by its mirror b ^ 1 -> a ^ 1, as ``build_oriented_graph``
    gives them), form the paths of ``long_paths``, then ``cycles`` cycles of
    lengths in ``cycle_lens`` (none starting at its least node; the last cut
    short where the nodes run out), then paths
    of lengths in ``lens``.  One node in eight takes its hi word from a pool
    of four and one in 64 another node's whole k-mer, so that the keep rule
    meets ties in either word."""
    rng = np.random.default_rng(seed)
    hi, lo = _rand_kmers(rng, n, k)
    tie = rng.random(n) < 1 / 8
    hi[tie] = rng.choice(hi[:4], int(tie.sum()))
    same = np.flatnonzero(rng.random(n) < 1 / 64)
    src = rng.integers(0, n, len(same))
    hi[same], lo[same] = hi[src], lo[src]
    is_pad = rng.random(n) < pad
    hi[is_pad] = lo[is_pad] = _SENT64
    real = rng.permutation(np.flatnonzero(~is_pad))
    units = 2 * real + rng.integers(0, 2, len(real)) if mirror else \
        rng.permutation(np.concatenate([2 * real, 2 * real + 1]))
    nxt = np.full(2 * n, -1, np.int64)
    at = 0

    def link(seg, cycle):
        if mirror:
            nxt[seg[1:] ^ 1] = seg[:-1] ^ 1
            if cycle:
                nxt[seg[0] ^ 1] = seg[-1] ^ 1
        nxt[seg[:-1]] = seg[1:]
        if cycle:
            nxt[seg[-1]] = seg[0]

    for ln in long_paths:
        link(units[at:at + ln], False)
        at += ln
    for ln in rng.integers(cycle_lens[0], cycle_lens[1] + 1, cycles):
        seg = units[at:at + ln].copy()  # the last may be cut short
        if len(seg) == 0:
            break
        if len(seg) > 1 and seg[0] == seg.min():
            seg[[0, 1]] = seg[[1, 0]]
        link(seg, True)
        at += ln
    # the paths: cut the rest at random lengths, vectorised
    rest = units[at:]
    cuts = np.cumsum(rng.integers(lens[0], lens[1] + 1, len(rest)))
    last = np.zeros(len(rest), bool)
    last[cuts[cuts <= len(rest)] - 1] = True
    last[-1:] = True
    nxt[rest[:-1][~last[:-1]]] = rest[1:][~last[:-1]]
    if mirror:
        nxt[rest[1:][~last[:-1]] ^ 1] = rest[:-1][~last[:-1]] ^ 1
    return nxt.astype(np.int32), hi, lo


def k9_cases(large: bool = False):
    """(name, chain_next, hi, lo, k) forests of K9's tests: paths, cycles
    (of one node, two, up to 80 with splitters and without) and padding rows
    at k = 21, 47 and 63, a mirrored forest, forests of cycles only and of
    no edge, M = 2 with a cycle and with none; ``large``: one path of 2^20
    oriented nodes beside 2^12 cycles."""
    for k in (21, 47, 63):
        yield (f"mixed_k{k}", *k9_forest(90 + k, 3000, k, long_paths=(700,),
                                         cycles=30, cycle_lens=(1, 80)), k)
    yield ("mirrored", *k9_forest(91, 3000, 47, cycles=12, mirror=True), 47)
    yield ("cycles_only", *k9_forest(92, 2000, 31, cycles=60,
                                     cycle_lens=(1, 200), pad=0.0), 31)
    hi, lo = _rand_kmers(np.random.default_rng(93), 500, 21)
    yield "no_edge", np.full(1000, -1, np.int32), hi, lo, 21
    hi, lo = _rand_kmers(np.random.default_rng(94), 1, 47)
    yield "m2_cycle", np.array([1, 0], np.int32), hi, lo, 47
    yield "m2_none", np.array([-1, -1], np.int32), hi, lo, 47
    if large:
        yield ("long_path", *k9_forest(95, 1 << 20, 47, long_paths=(1 << 20,),
                                       cycles=1 << 12, cycle_lens=(1, 64),
                                       pad=0.1), 47)


def k9_numpy(out):
    """``contract_cuda.contract``'s outputs (tensors, n_bad last) -> the
    form of ``k9_host``: numpy, k-mer words uint64, tail_of -1 off the
    heads (where K9 leaves scratch)."""
    import torch

    from sh_assembly_tpu_torch.ops import bits

    got = [bits.to_u64_np(a) if a.dtype == torch.int64 else a.cpu().numpy()
           for a in out[:-1]]
    got[2] = np.where(got[0] != np.arange(len(got[0])), -1,
                      got[2]).astype(np.int32)
    return tuple(got)


def k9_host(chain_next, hi, lo, k: int):
    """The plain twins' contraction of a k9_cases forest on the CPU (numpy
    in and out; tier-1 holds them against the JAX package) -> (head, dist,
    tail_of, keep, rhi, rlo), as ``k9_numpy`` gives them."""
    import torch

    from sh_assembly_tpu_torch.ops import bits, contract_cuda

    cpu = torch.device("cpu")
    return k9_numpy(contract_cuda.contract(
        torch.from_numpy(chain_next), bits.from_u64_np(hi, cpu),
        bits.from_u64_np(lo, cpu), k))


def k9_compare(name, got, want) -> None:
    """K9's or its plain twins' outputs (``contract``'s tensors) against
    ``k9_host``'s, bitwise (tail_of at the heads), with n_bad 0."""
    n_bad = int(got[-1].item())
    if n_bad != 0:
        raise AssertionError(f"K9 on {name}: n_bad {n_bad}")
    for f, a, b in zip(("head", "dist", "tail_of", "keep", "rhi", "rlo"),
                       k9_numpy(got), want):
        if a.dtype != b.dtype or a.shape != b.shape or \
                not np.array_equal(a, b):
            bad = int((a != b).sum()) if a.shape == b.shape else "all"
            raise AssertionError(f"K9 on {name}: {f} differs from the plain "
                                 f"twins in {bad} entries")


def k10_forest(seed: int, n: int, k: int, palindromes: int = 0, **kw):
    """A chain forest (``k9_forest``) with what the members step reads
    besides -> (chain_next, hi, lo, real, node_counts) numpy: real where a
    node is no padding row, counts in [2, 60).  ``palindromes``: that many
    paths of two nodes or more get a last node whose mirror's k-mer is
    their head's (a palindromic head: the keep rule keeps both mirrors)."""
    from sh_assembly_tpu_torch.ops import kmerpack_np as kpn

    cn, hi, lo = k9_forest(seed, n, k, **kw)
    rng = np.random.default_rng(seed + 1)
    if palindromes:
        head, _, tail_of, *_ = k9_host(cn, hi, lo, k)
        tails = rng.permutation(np.sort(tail_of[tail_of >= 0]))
        used, done = set(), 0
        for t in tails:
            h = int(head[t])
            if done == palindromes or {h >> 1, t >> 1} & used or \
                    h >> 1 == t >> 1 or hi[h >> 1] == _SENT64:
                continue
            w = (hi[h >> 1:(h >> 1) + 1], lo[h >> 1:(h >> 1) + 1])
            if h & 1:
                w = kpn.revcomp_packed(*w, k)
            if not t & 1:  # the mirror t ^ 1 reads the node reversed
                w = kpn.revcomp_packed(*w, k)
            hi[t >> 1], lo[t >> 1] = w[0][0], w[1][0]
            used |= {h >> 1, t >> 1}
            done += 1
        if done != palindromes:
            raise ValueError(f"{done} paths for {palindromes} palindromes")
    real = hi != _SENT64
    counts = rng.integers(2, 60, n).astype(np.int32)
    return cn, hi, lo, real, counts


def k10_cases(large: bool = False):
    """(name, chain_next, hi, lo, real, node_counts, k) cases of K10's
    tests, at k = 21, 31, 47 and 63 each: ``k9_cases``' kinds of forest
    (paths, cycles not starting at their least node, padding rows; a
    mirrored forest, here with 40 palindromic heads; cycles only; M = 2
    with a cycle and with none) and a store of padding rows alone, whose
    kept heads hold no member; ``large``: the E. coli cell's extent
    (``K9_SHAPE``, 2^24 oriented nodes)."""
    for k in (21, 31, 47, 63):
        yield (f"mixed_k{k}", *k10_forest(90 + k, 3000, k, long_paths=(700,),
                                          cycles=30, cycle_lens=(1, 80)), k)
        yield (f"mirrored_k{k}", *k10_forest(91 + k, 3000, k, cycles=12,
                                             mirror=True, palindromes=40), k)
        yield (f"cycles_k{k}", *k10_forest(92 + k, 2000, k, cycles=60,
                                           cycle_lens=(1, 200), pad=0.0), k)
        yield (f"no_member_k{k}", *k10_forest(93 + k, 500, k, pad=1.0), k)
        hi, lo = _rand_kmers(np.random.default_rng(94 + k), 1, k)
        one = (np.ones(1, bool), np.array([7], np.int32))
        yield f"m2_cycle_k{k}", np.array([1, 0], np.int32), hi, lo, *one, k
        yield f"m2_none_k{k}", np.array([-1, -1], np.int32), hi, lo, *one, k
    if large:
        s = K9_SHAPE
        yield ("cell_extent", *k10_forest(
            s["seed"], s["nodes"], s["k"], lens=s["lens"],
            long_paths=s["long_paths"], cycles=s["cycles"], pad=s["pad"],
            mirror=True), s["k"])


class K10Members(NamedTuple):
    """The members of kept oriented paths in (head, dist) order, numpy: the
    form of the JAX package's members step (the first lines of its
    ``_finalize_host``)."""

    ai: np.ndarray  # int64 oriented index
    node_i: np.ndarray  # int64 ai >> 1
    ohi: np.ndarray  # uint64 oriented k-mer
    olo: np.ndarray
    lastb: np.ndarray  # uint8 its last base
    counts_mem: np.ndarray  # int64 its node's count
    starts: np.ndarray  # int64 [P] each path's first member
    lens: np.ndarray  # int64 [P]
    tail_pos: np.ndarray  # int64 [P] each path's last member
    head_idx: np.ndarray  # int64 [P] each path's head


def k10_numpy(placed) -> K10Members | None:
    """K10's (or its plain twin's) output tensors, every one of them, as a
    ``K10Members``; None where there is no member."""
    from sh_assembly_tpu_torch.ops import bits

    ai_t, ohi, olo, lastb, counts, starts, head_idx = placed
    if ai_t.numel() == 0:
        return None
    ai = ai_t.cpu().numpy().astype(np.int64)
    starts = starts.cpu().numpy().astype(np.int64)
    lens = np.diff(np.r_[starts, len(ai)])
    return K10Members(ai, ai >> 1, bits.to_u64_np(ohi), bits.to_u64_np(olo),
                      lastb.cpu().numpy(),
                      counts.cpu().numpy().astype(np.int64), starts, lens,
                      starts + lens - 1,
                      head_idx.cpu().numpy().astype(np.int64))


def k10_host(chain_next, hi, lo, real, counts, k: int):
    """The plain twins' members step on a k10_cases case, on the CPU (tier-1
    holds them against the JAX package) -> ``K10Members`` (None where no
    path has a member)."""
    from sh_assembly_tpu_torch.ops import members_cuda

    args = k10_inputs(chain_next, hi, lo, real, counts, k, "cpu")
    return k10_numpy(members_cuda.members(*args, k))


def k10_inputs(chain_next, hi, lo, real, counts, k: int, device):
    """K10's inputs from a k10_cases case on ``device``: the contraction
    there (``contract_cuda.contract``: K9 on a GPU, its twins otherwise)."""
    import torch

    from sh_assembly_tpu_torch.ops import bits, contract_cuda

    cn = torch.from_numpy(chain_next).to(device)
    h, l = bits.from_u64_np(hi, device), bits.from_u64_np(lo, device)
    head, dist, tail_of, keep, rhi, rlo, _ = contract_cuda.contract(cn, h, l,
                                                                    k)
    return (head, dist, tail_of, keep, h, l, rhi, rlo,
            torch.from_numpy(real).to(device),
            torch.from_numpy(counts).to(device))


def k10_compare(name, got, want) -> None:
    """K10's or its plain twin's outputs (tensors), all of them
    (``k10_numpy``), against ``k10_host``'s, bitwise."""
    got = k10_numpy(got)
    if (got is None) != (want is None):
        raise AssertionError(f"K10 on {name}: members "
                             f"{'none' if got is None else 'some'}, the "
                             f"twin {'none' if want is None else 'some'}")
    if got is None:
        return
    for f, a, b in zip(want._fields, got, want):
        if a.dtype != b.dtype or a.shape != b.shape or \
                not np.array_equal(a, b):
            bad = int((a != b).sum()) if a.shape == b.shape else "all"
            raise AssertionError(f"K10 on {name}: {f} differs from the "
                                 f"plain twin in {bad} entries")


# counts up to the spectrum's saturation cap (``spectrum.count_cap``: 2^30
# at the cells' key_bits)
K11_CAP = 1 << 30


def k11_paths(seed: int, lens, counts=(2, 60), seed_share: float = 0.3,
              mask: bool = True):
    """K11's inputs for paths of the given lengths -> (counts, starts, ai,
    seed) numpy: counts int32 in [counts[0], counts[1]], starts int32, ai
    int32 oriented indices over as many nodes as members, seed a bool mask
    over those nodes (a share of them set) or None."""
    rng = np.random.default_rng(seed)
    lens = np.asarray(lens, np.int64)
    M = int(lens.sum())
    starts = (np.cumsum(lens) - lens).astype(np.int32)
    c = rng.integers(counts[0], counts[1], M, endpoint=True).astype(np.int32)
    nodes = max(M, 1)
    ai = rng.integers(0, 2 * nodes, M).astype(np.int32)
    sd = rng.random(nodes) < seed_share if mask else None
    return c, starts, ai, sd


def k11_cases():
    """(name, counts, starts, ai, seed, smin, smax) numpy cases of K11's
    tests: paths of one member; every length a warp takes; lengths around
    the warp's limit and the block's in-block limit (4096 staged members)
    and far beyond it; counts over the whole range up to the cap (several
    radix passes) and at the cap; every count of a path equal; even paths
    of two values split at and beside their middle; no seed mask; no path."""
    rng = np.random.default_rng(110)
    yield "singles", *k11_paths(111, np.ones(1000, np.int64)), 3, 40
    yield "warp_lengths", *k11_paths(112, rng.integers(1, 33, 3000)), 5, 50
    yield ("warp_edges", *k11_paths(113, [1, 2, 31, 32, 33, 34, 63, 64, 65,
                                          256, 257] * 12), 5, 50)
    yield ("mixed", *k11_paths(114, np.r_[rng.integers(1, 200, 2000),
                                          [4095, 4096, 4097, 4098, 20000,
                                           20001]], counts=(0, 1000)), 10,
           900)
    yield ("wide_counts", *k11_paths(
        115, np.r_[rng.integers(1, 100, 500), [5000, 5001, 70000, 70001]],
        counts=(0, K11_CAP)), 1 << 20, K11_CAP)
    c, starts, ai, sd = k11_paths(116, np.r_[rng.integers(1, 80, 400),
                                             [40, 41, 6000, 6001]],
                                  counts=(K11_CAP - 3, K11_CAP))
    c[rng.random(len(c)) < 0.5] = K11_CAP  # saturated counts
    yield "at_cap", c, starts, ai, sd, 2, K11_CAP
    lens = np.r_[rng.integers(1, 60, 300), [33, 34, 5000, 5001]]
    c, starts, ai, sd = k11_paths(117, lens)
    c = np.repeat(rng.integers(0, 1000, len(lens)), lens).astype(np.int32)
    yield "equal_counts", c, starts, ai, sd, 0, 500
    parts = []  # even paths of two values: L / 2 or L / 2 - 1 of the lower
    for L, low in ((5000, 2500), (5000, 2499), (5000, 2501), (40, 20),
                   (40, 19), (6000, 1), (6000, 5999), (10, 5)):
        v = np.r_[np.full(low, 7), np.full(L - low, 9 + L % 3)]
        parts.append(rng.permutation(v))
    c, starts, ai, sd = k11_paths(118, [len(v) for v in parts])
    yield "two_values", np.concatenate(parts).astype(np.int32), starts, ai, \
        sd, 8, 8
    yield ("no_seed_mask", *k11_paths(119, np.r_[rng.integers(1, 300, 800),
                                                 [9000]], mask=False), 3, 40)
    e = np.zeros(0, np.int32)
    yield "no_path", e, e, e, np.zeros(4, bool), 2, 9


def k11_inputs(counts, starts, ai, seed, device):
    """A k11_cases case's arrays as tensors on ``device``."""
    import torch

    return (torch.from_numpy(counts).to(device),
            torch.from_numpy(starts).to(device),
            torch.from_numpy(ai).to(device),
            None if seed is None else torch.from_numpy(seed).to(device))


def k11_host(counts, starts, ai, seed, smin, smax):
    """The plain twin on a k11_cases case, on the CPU (tier-1 holds it
    against the JAX package's lexsort) -> (med, sum, flag) numpy."""
    from sh_assembly_tpu_torch.ops import path_stats_cuda

    return tuple(t.numpy() for t in path_stats_cuda.path_stats(
        *k11_inputs(counts, starts, ai, seed, "cpu"), smin, smax))


def k11_compare(name, got, want) -> None:
    """K11's or its twin's (med, sum, flag) tensors against numpy ones,
    bitwise."""
    for f, a, b in zip(("med", "sum", "flag"), got, want):
        a = a.cpu().numpy()
        if a.dtype != b.dtype or a.shape != b.shape or \
                not np.array_equal(a, b):
            bad = int((a != b).sum()) if a.shape == b.shape else "all"
            raise AssertionError(f"K11 on {name}: {f} differs from the "
                                 f"plain twin in {bad} entries")


def links_ends(seed: int, k: int, n: int = 600, palindromes: int = 20,
               repeats: int = 10):
    """The ends of n unitig-like paths of a random genome -> (fhi, flo, thi,
    tlo) uint64 numpy: consecutive pieces overlap by k - 1 bases (after and
    before links), a third of them reversed (links to - entries), pieces
    of one k-mer, siblings of some ends (a first base changed), that many
    palindromic paths (first k-mer = reverse complement of the last: a
    repeated table key) and that many first k-mers repeated on later paths
    (the last write wins)."""
    import torch

    from sh_assembly_tpu_torch.ops import bits, kmerpack as kp

    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 30, n)  # k-mers a piece
    cuts = np.r_[0, np.cumsum(lens)]
    genome = rng.integers(0, 4, int(cuts[-1]) + k).astype(np.uint8)
    hi, lo = kp.pack_windows(torch.from_numpy(genome)[None], k)
    hi, lo = bits.to_u64_np(hi[0]), bits.to_u64_np(lo[0])
    f, t = cuts[:-1], cuts[1:] - 1  # first and last window of each piece
    fhi, flo, thi, tlo = hi[f], lo[f], hi[t], lo[t]
    rev = rng.random(n) < 1 / 3  # the piece read on the other strand
    from sh_assembly_tpu_torch.ops import kmerpack_np as kpn

    rf, rt = kpn.revcomp_packed(fhi, flo, k), kpn.revcomp_packed(thi, tlo, k)
    fhi, flo, thi, tlo = (np.where(rev, a, b) for a, b in (
        (rt[0], fhi), (rt[1], flo), (rf[0], thi), (rf[1], tlo)))
    sib = rng.choice(n, n // 10, replace=False)  # a first base changed
    top = np.uint64(3) << np.uint64(62)
    fhi[sib] ^= top & (np.uint64(rng.integers(1, 4)) << np.uint64(62))
    pal = rng.choice(n, palindromes, replace=False)
    thi[pal], tlo[pal] = kpn.revcomp_packed(fhi[pal], flo[pal], k)
    rep = rng.choice(n - 1, repeats, replace=False)
    fhi[rep + 1], flo[rep + 1] = fhi[rep], flo[rep]
    return fhi, flo, thi, tlo


def links_cases():
    """(name, fhi, flo, thi, tlo, k) cases of the link join's tests at k =
    21, 31, 32, 33, 47 and 63 (both words, and hi alone), one path, and
    no path."""
    for k in PROBE_KS:
        yield f"genome_k{k}", *links_ends(120 + k, k), k
    one = links_ends(119, 47, n=1, palindromes=1, repeats=0)
    yield "one_palindrome", *one, 47
    e = np.zeros(0, np.uint64)
    yield "no_path", e, e, e, e, 47


def links_inputs(fhi, flo, thi, tlo, k: int, device):
    """The link join's inputs from a links_cases case on ``device``: the
    ends and their reverse complements."""
    from sh_assembly_tpu_torch.ops import bits, kmerpack as kp

    f = (bits.from_u64_np(fhi, device), bits.from_u64_np(flo, device))
    t = (bits.from_u64_np(thi, device), bits.from_u64_np(tlo, device))
    return (*f, *t, *kp.revcomp_packed(*f, k), *kp.revcomp_packed(*t, k))


def links_host(fhi, flo, thi, tlo, k: int):
    """The plain twin on a links_cases case, on the CPU (tier-1 holds it
    against the JAX package's joins) -> (av4, bv4, sv8) numpy."""
    from sh_assembly_tpu_torch.ops import links_cuda

    return tuple(v.numpy() for v in links_cuda.links(
        *links_inputs(fhi, flo, thi, tlo, k, "cpu"), k))


def links_compare(name, got, want) -> None:
    """The link join's (av4, bv4, sv8) tensors against numpy ones,
    bitwise."""
    for f, a, b in zip(("after", "before", "siblings"), got, want):
        a = a.cpu().numpy()
        if a.dtype != b.dtype or a.shape != b.shape or \
                not np.array_equal(a, b):
            bad = int((a != b).sum()) if a.shape == b.shape else "all"
            raise AssertionError(f"the link join on {name}: {f} differs "
                                 f"from the plain twin in {bad} entries")


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

    from sh_assembly_tpu_torch.ops import _build, blocksort_cuda, \
        contract_cuda, hash_append_cuda, join_cuda, members_cuda, \
        merge128_cuda, merge_cuda, node_join_cuda, path_stats_cuda, \
        probe_cuda, stage_cuda

    print("== phase 1: build", flush=True)
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)  # build from source
    t0 = time.time()
    # one nvcc per source, all started together
    mods = (merge_cuda, join_cuda, merge128_cuda, blocksort_cuda,
            hash_append_cuda, stage_cuda, node_join_cuda, probe_cuda,
            contract_cuda, members_cuda, path_stats_cuda)
    with ThreadPoolExecutor(len(mods)) as ex:
        for f in [ex.submit(m.build) for m in mods]:
            f.result()
    for name in ("merge_dedup", "count_join", "merge128", "block_sort",
                 "hash_append", "stage_windows", "node_join", "node_probes",
                 "contract", "members", "path_stats"):
        print(f"built {name} (sm_90a) -> {_build.lib_path(name)}")
    print(f"  all kernels built in {time.time() - t0:.2f} s")
    # K5's and K6's tiles: their real stacks (8 x 8192 rows) and a long row
    for what, rows, L in (("profile.hot's and stage 2's stack", 8 * 8192,
                           160),
                          ("phase 7's stack", 8 * 8192, 152),
                          (f"rows of {K5_LONG_ROW}", 4, K5_LONG_ROW)):
        for kn, mod in (("K5", hash_append_cuda), ("K6", stage_cuda)):
            print(f"  {kn} plan, {what} at k=47: {mod.plan(rows, L, 47)}")


def _time_ms(fn, reps: int) -> float:
    """Median over reps calls of fn's time between CUDA events."""
    from sh_assembly_tpu_torch.utils.profiling import median_ms

    return median_ms(fn, reps, "cuda")


def _queued_ms(fn, reps: int) -> float:
    """Device milliseconds a call of fn, the host's launch path hidden
    (``utils.profiling.queued_ms``)."""
    from sh_assembly_tpu_torch.utils.profiling import queued_ms

    return queued_ms(fn, reps)


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
    from sh_assembly_tpu_torch.ops import hash_append_cuda as ha
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
    mc.LAUNCHES = ha.LAUNCHES = 0
    stats, _, wall = _run_cli(MAIN_FLAGS + [
        "-i", os.path.join(d, "ReadFiles.txt"), "-o", ser, "--device", "cuda"])
    launches, k5 = mc.LAUNCHES, ha.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    # the main thread's top-level phases (children lie inside their
    # parents; the reader's thread runs beside them)
    count_s = sum(s.seconds for n, s in profiling.GLOBAL.stats.items()
                  if s.parent is None
                  and n not in ("count:serialize", "count:reader next"))
    appends = profiling.GLOBAL.stats["count:device append"].calls
    meta = _ser_meta(ser)
    print(f"  {stats}; K1 launches {launches}; K5 launches {k5}, "
          f"count:device append {appends} calls for {stats['batches']} "
          f"batches")
    if launches < stats["merges"] + stats["sweeps"] or stats["merges"] < 3:
        raise AssertionError(f"K1 launches {launches} < merges + sweeps")
    if not 0 < k5 < stats["batches"] or appends >= stats["batches"]:
        raise AssertionError(f"K5 did not append by the stack: {k5} "
                             f"launches, {appends} append calls for "
                             f"{stats['batches']} batches")
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


@contextlib.contextmanager
def _spies(*targets):
    """Count the calls of each (module, attribute) function while the block
    runs -> the list of counts, one a target, read after the block."""
    counts = [0] * len(targets)
    saved = [getattr(m, a) for m, a in targets]

    def counting(i, fn):
        def call(*a, **kw):
            counts[i] += 1
            return fn(*a, **kw)
        return call

    for i, ((m, a), fn) in enumerate(zip(targets, saved)):
        setattr(m, a, counting(i, fn))
    try:
        yield counts
    finally:
        for (m, a), fn in zip(targets, saved):
            setattr(m, a, fn)


def _launch_counters():
    from sh_assembly_tpu_torch.ops import contract_cuda, hash_append_cuda, \
        join_cuda, links_cuda, members_cuda, merge128_cuda, merge_cuda, \
        node_join_cuda, path_stats_cuda, probe_cuda, stage_cuda

    return {"merge_dedup": merge_cuda, "count_join": join_cuda,
            "merge128": merge128_cuda, "hash_append": hash_append_cuda,
            "stage_windows": stage_cuda, "node_join": node_join_cuda,
            "node_probes": probe_cuda, "contract": contract_cuda,
            "members": members_cuda, "path_stats": path_stats_cuda,
            "links": links_cuda}


def _reset_launches():
    from sh_assembly_tpu_torch.ops import node_join_cuda

    for m in _launch_counters().values():
        m.LAUNCHES = 0
    node_join_cuda.KINDS = dict.fromkeys(node_join_cuda.KINDS, 0)


def _launches():
    return {name: m.LAUNCHES for name, m in _launch_counters().items()}


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
    if not all(launches[n] for n in ("count_join", "merge128",
                                     "stage_windows", "node_join",
                                     "node_probes", "contract", "members",
                                     "path_stats", "links")):
        raise AssertionError(f"K2, K3, K6-K11 or the link join never "
                             f"launched in cli.contiger: {launches}")
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

    from sh_assembly_tpu_torch.models import contiger
    from sh_assembly_tpu_torch.ops import kmerpack as kp, node_join_cuda, \
        probe_cuda, stage_cuda
    from sh_assembly_tpu_torch.profile import node_join as prof_nj
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
    # count calls of the collect staging, the probe programs and the
    # one-shot node join, and of the plain versions of K6, K7 and K8, which
    # the card must never run on this path (K9's and K10's route shows in
    # their launches); time every call into K7's library; keep the
    # closure's and the contraction's inputs for the checks below.  One
    # join first loads K7's kernels (CUDA loads a module at its first
    # launch), so that the timed calls are device work
    t = torch.zeros(1, dtype=torch.int64, device="cuda")
    node_join_cuda.node_join(t, t, t, t)
    _reset_launches()
    closure_in, finalize_in = [], []
    real_closure, real_finalize = (contiger.close_over_phantoms,
                                   contiger.finalize_unitigs)

    def keep_closure(*a, **kw):
        closure_in.append(a)
        return real_closure(*a, **kw)

    def keep_finalize(*a, **kw):
        finalize_in.append((a, kw))
        return real_finalize(*a, **kw)

    contiger.close_over_phantoms = keep_closure
    contiger.finalize_unitigs = keep_finalize
    try:
        with _spies((contiger, "_stage_super"),
                    (stage_cuda, "stage_windows_plain"),
                    (contiger, "phantom_candidates"),
                    (contiger, "build_oriented_graph"), (kp, "join2"),
                    (kp, "join2_plain"),
                    (probe_cuda, "node_probes_plain")) as calls, \
                prof_nj.timed_calls() as k7_calls:
            _, logtxt, wall = _run_cli(GENOME_FLAGS + [
                "-i", os.path.join(d, "ReadFiles.txt"),
                "-o", os.path.join(d, "contigs.fa"),
                "--unitigs", os.path.join(d, "unitigs.fa"), "--device",
                "cuda"], cli="pipeline")
    finally:
        contiger.close_over_phantoms = real_closure
        contiger.finalize_unitigs = real_finalize
    supers, plain, closure, graph, joins, joins_plain, probes_plain = calls
    launches = _launches()
    kinds = dict(node_join_cuda.KINDS)
    peak = torch.cuda.max_memory_allocated()
    if launches["contract"] != 3:
        raise AssertionError(f"the contraction did not run through K9 (a "
                             f"ranking, the reverse complements and the "
                             f"keep rule): {launches['contract']} calls into "
                             f"its library")
    if launches["members"] != 1:
        raise AssertionError(f"the members step did not run through K10 (one "
                             f"placement): {launches['members']} placements")
    if launches["path_stats"] != 1 or launches["links"] != 1:
        raise AssertionError(f"the medians and the link join did not run "
                             f"through K11 and K7 once each: "
                             f"{launches['path_stats']} and "
                             f"{launches['links']} calls")
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
    print(f"  collect staging: {supers} _stage_super calls, "
          f"{launches['stage_windows']} K6 launches, {plain} calls of the "
          f"plain chain")
    if launches["stage_windows"] != supers or plain:
        raise AssertionError("collect_nodes did not stage through one K6 "
                             "launch a _stage_super call")
    print(f"  probe programs: {closure} phantom_candidates and {graph} "
          f"build_oriented_graph calls, {launches['node_probes']} K8 "
          f"launches, {probes_plain} calls of its plain chain; K7 "
          f"{launches['node_join']} launches ({kinds}), {joins} one-shot "
          f"join2 calls, {joins_plain} calls of join2_plain")
    # one table a Contiger run: built once (this store never fills or
    # outgrows its padded extent), each round that found phantoms appends
    # them, every round and the graph probe it; and the host assembly's
    # link table, built and probed once
    if launches["node_probes"] != closure + graph or probes_plain or \
            graph != 1 or kinds != dict(build=2, append=closure - 1,
                                        probe=closure + graph + 1) or \
            launches["node_join"] != sum(kinds.values()) or joins or \
            joins_plain:
        raise AssertionError("the probe programs did not probe through one "
                             "K8 launch a call and one K7 table (a build, "
                             "an append a round that found phantoms, a "
                             "probe a round and one for the graph), and "
                             "the link join through a table of its own")
    torch.cuda.synchronize()
    k7 = [(name, ints, a.elapsed_time(b)) for name, ints, a, b in k7_calls]
    for name, ints, ms in k7:
        print(f"    K7 {name}{tuple(ints)}: {ms:.4f} ms")
    print(f"  K7 device time on the main path: {sum(t for *_, t in k7):.4f} "
          f"ms in {len(k7)} calls", flush=True)
    stats = profiling.GLOBAL.stats
    appends, batches = (stats[p].calls for p in (
        "count:device append", "count:host read/pack"))
    if appends >= batches - 1 or launches["hash_append"] >= batches - 1:
        raise AssertionError(f"K5 did not append by the stack: "
                             f"{launches['hash_append']} launches, "
                             f"{appends} append calls for {batches - 1} "
                             f"batches")
    if abs(total - GENOME["genome_len"]) > 0.1 * GENOME["genome_len"]:
        raise AssertionError(f"contigs total {total} bp not within 10% of "
                             f"the {GENOME['genome_len']} bp genome")
    k7_closure_check(closure_in[0])
    k9_route_check(finalize_in[0], os.path.join(d, "unitigs.fa"))
    return launches


def k9_route_check(call, unitigs_fa: str) -> None:
    """``finalize_unitigs`` again on the pipeline's own inputs, moved to the
    CPU: the plain twins' ``unitigs.fa`` must be the CUDA run's (K9's and
    K10's), byte for byte."""
    from sh_assembly_tpu_torch.models import contiger

    (hi, lo, real, counts, chain_next, params), kw = call
    t0 = time.time()
    arrays = contiger.finalize_unitigs(hi.cpu(), lo.cpu(), real, counts.cpu(),
                                       chain_next.cpu(), params, **kw)
    path = unitigs_fa + ".cpu"
    arrays.write_fasta(path)
    same = open(path, "rb").read() == open(unitigs_fa, "rb").read()
    os.remove(path)
    if not same:
        raise AssertionError("the plain twins' unitigs.fa differs from K9's "
                             "and K10's")
    print(f"  the plain twins on the same forest, on the CPU "
          f"({time.time() - t0:.1f} s): unitigs.fa byte-identical to K9's and "
          f"K10's", flush=True)


def k7_closure_check(args) -> None:
    """The closure and the graph probe of ``assemble_unitigs_arrays`` again
    on the same inputs, outside the counted run: every probe of the one
    table must equal ``join2_plain`` on that round's padded store, which
    is the store the table holds (its real rows, then sentinel rows to
    the JAX package's extent), bitwise."""
    import torch

    from sh_assembly_tpu_torch.models import contiger
    from sh_assembly_tpu_torch.ops import kmerpack as kp, node_join_cuda

    spec, hi, lo, k, key_bits, amin = args
    checked = []
    probe = node_join_cuda.NodeTable.probe

    def checked_probe(self, qhi, qlo):
        got = probe(self, qhi, qlo)
        n, N = self.n_real, self.hi.numel()
        pad = 1 << max((max(n, 1024) - 1).bit_length(), 10)
        want = kp.join2_plain(self.hi, self.lo, qhi, qlo)
        if N != pad or not bool((self.hi[n:] == -1).all()) or \
                not bool((self.lo[n:] == -1).all()) or \
                not torch.equal(got, want):
            raise AssertionError(f"K7 table probe {len(checked)} ({n} real "
                                 f"rows in {N}, {qhi.numel()} queries) is "
                                 f"not join2_plain on the padded store")
        checked.append((n, qhi.numel()))
        return got

    node_join_cuda.NodeTable.probe = checked_probe
    try:
        table = node_join_cuda.NodeTable()
        hi, lo, _ = contiger.close_over_phantoms(spec, hi, lo, k, key_bits,
                                                 amin, table=table)
        contiger.build_oriented_graph(spec, table.hi, table.lo, k, key_bits,
                                      amin, table=table)
    finally:
        node_join_cuda.NodeTable.probe = probe
    del table
    torch.cuda.empty_cache()
    print(f"  K7 table: {len(checked)} probes (the closure's rounds and the "
          f"graph) identical to join2_plain on their padded stores "
          f"((real rows, queries): {checked})", flush=True)


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


def _sort_bytes_per_key(device, n=1 << 27, key_bits=37):
    """Device bytes the buffer sort allocates per key at its peak, beyond
    the buffer (``spectrum.SORT_BYTES_PER_KEY`` is this measurement)."""
    import torch

    from sh_assembly_tpu_torch.ops import spectrum as sp

    g = torch.Generator(device=device).manual_seed(9)
    buf = torch.randint(0, 1 << key_bits, (n,), generator=g, device=device)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = sp.sort_pack_buf(buf, key_bits)
    torch.cuda.synchronize()
    need = (torch.cuda.max_memory_allocated() - base) / n
    del buf, out
    torch.cuda.empty_cache()
    return need


def _mesh_cli(argv, cli):
    """One of the port's CLIs with its phase breakdown and the peak device
    memory -> (stats, log, wall, peak bytes, phases)."""
    import torch

    from sh_assembly_tpu_torch.utils import profiling

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats, logtxt, wall = _run_cli(argv, cli=cli)
    phases = {n: s.seconds for n, s in profiling.GLOBAL.stats.items()}
    return stats, logtxt, wall, torch.cuda.max_memory_allocated(), phases


def _scan_note(phases, k5: int) -> str:
    """The mesh counter's scan phase ((seconds, calls) in ``phases``) and
    K5's launches, for a line."""
    sec, calls = phases.get("count:mesh scan", (0.0, 0))
    return f"count:mesh scan {sec:.3f} s in {calls} calls, K5 launches {k5}"


def _mesh_phases() -> dict:
    """The phases of the last CLI run: name -> (seconds, calls)."""
    from sh_assembly_tpu_torch.utils import profiling

    return {n: (s.seconds, s.calls)
            for n, s in profiling.GLOBAL.stats.items()}


def phase10_mesh():
    """The mesh path (``parallel/``, --mesh on both CLIs) on the card.
    Returns the kernel launches of 10c, the mesh path at a genome users
    assemble."""
    import torch

    from sh_assembly_tpu_torch.cli import compare_contigs, minia
    from sh_assembly_tpu_torch.ops import hash_append_cuda as ha
    from sh_assembly_tpu_torch.ops import merge_cuda as mc
    from sh_assembly_tpu_torch.parallel import dryrun
    from sh_assembly_tpu_torch.profile import mesh as pmesh

    print("== phase 10: the mesh path (n key-range shards on the card)",
          flush=True)
    # 10a: CPU and CUDA bytes, mid-stream sweeps on the summed trigger
    d = os.path.join(WORK, "parity")
    if not os.path.exists(os.path.join(d, "reads.fastq")):
        write_fastq(os.path.join(d, "reads.fastq"), **PARITY)
    out = {}
    for dev in ("cpu", "cuda"):
        ser = os.path.join(d, f"mesh8_{dev}.ser")
        _reset_launches()
        stats, logtxt, wall = _run_cli(PARITY_FLAGS + [
            "-i", os.path.join(d, "ReadFiles.txt"), "-o", ser, "--mesh",
            "8", "--device", dev])
        mid = logtxt.count(" mid-stream: ")
        k5 = _launches()["hash_append"]
        print(f"  10a cqf_denoise --mesh 8 {dev}: {stats} mid-stream sweeps "
              f"{mid}, wall {wall:.1f} s, launches {_launches()}; "
              f"{_scan_note(_mesh_phases(), k5)}")
        out[dev] = (open(ser, "rb").read(), mid, _launches())
    if out["cpu"][0] != out["cuda"][0]:
        raise AssertionError("--mesh 8: CPU and CUDA .ser files differ")
    if out["cuda"][1] < 1 or any(
            not out["cuda"][2][n] or out["cpu"][2][n]
            for n in ("merge_dedup", "hash_append")):
        raise AssertionError("--mesh 8: no mid-stream sweep, or K1 or K5 "
                             "not on the card only")
    print(f"  10a .ser byte-identical ({len(out['cpu'][0])} bytes)")
    fa = {}
    for dev in ("cpu", "cuda"):
        _reset_launches()
        _, _, wall = _run_cli([
            "-k", PARITY_FLAGS[1], "-i", os.path.join(d, "ReadFiles.txt"),
            "-c", os.path.join(d, "mesh8_cpu.ser"), "--mesh", "4",
            "-o", os.path.join(d, f"mesh4_{dev}.fa"), "--device", dev],
            cli="contiger")
        fa[dev] = (open(os.path.join(d, f"mesh4_{dev}.fa"), "rb").read(),
                   _launches())
        print(f"  10a contiger --mesh 4 {dev}: wall {wall:.1f} s, "
              f"{fa[dev][0].count(b'>')} unitigs, launches {fa[dev][1]}")
    if fa["cpu"][0] != fa["cuda"][0]:
        raise AssertionError("--mesh 4: CPU and CUDA unitigs.fa differ")
    if not (fa["cuda"][1]["count_join"] and fa["cuda"][1]["merge128"]):
        raise AssertionError("--mesh 4: K2 or K3 never launched")
    print("  10a unitigs.fa byte-identical")

    # 10b: counting at C. elegans state (2^29 slots), --mesh 8 against the
    # single store of phase 4: its flags' trigger (310 M distinct) is never
    # reached, so no sweep fires mid-stream and the two cadences agree
    d = os.path.join(WORK, "main")
    single = os.path.join(d, "main.ser")
    if not os.path.exists(single):
        write_fastq(os.path.join(d, "reads.fastq"), **MAIN)
        _run_cli(MAIN_FLAGS + ["-i", os.path.join(d, "ReadFiles.txt"),
                               "-o", single, "--device", "cuda"])
    ser = os.path.join(d, "mesh8.ser")
    _reset_launches()
    stats, logtxt, wall, peak, phases = _mesh_cli(
        MAIN_FLAGS + ["-i", os.path.join(d, "ReadFiles.txt"), "-o", ser,
                      "--mesh", "8", "--device", "cuda"], "cqf_denoise")
    count_s = sum(v for n, v in phases.items()
                  if n not in ("count:serialize", "count:mesh gather"))
    print(f"  10b --mesh 8: {stats}; counting {count_s:.2f} s "
          f"({stats['kmers'] / count_s:.0f} k-mers/s), CLI wall {wall:.2f} s, "
          f"peak device memory {peak / 2**30:.2f} GiB, K1 launches "
          f"{mc.LAUNCHES}; {_scan_note(_mesh_phases(), ha.LAUNCHES)}")
    if not ha.LAUNCHES:
        raise AssertionError("--mesh 8: K5 never launched")
    if " mid-stream: " in logtxt or open(single, "rb").read() != \
            open(ser, "rb").read():
        raise AssertionError("--mesh 8 .ser differs from phase 4's single "
                             "store's, or a sweep fired mid-stream")
    print(f"  10b .ser byte-identical to phase 4's ({os.path.getsize(ser)} "
          f"bytes); the buffer sort takes "
          f"{_sort_bytes_per_key('cuda'):.2f} B/key at its peak (2^27 keys)")

    # 10c: the 12 Mbp genome of phase 7 through both CLIs at --mesh 4
    d = os.path.join(WORK, "genome")
    if not os.path.exists(os.path.join(d, "reads.fastq")):
        write_fastq(os.path.join(d, "reads.fastq"), **GENOME)
    ser = os.path.join(d, "mesh4.ser")
    ufa = os.path.join(d, "mesh4_unitigs.fa")
    _reset_launches()
    stats, _, wall, peak, phases = _mesh_cli(GENOME_FLAGS + [
        "-i", os.path.join(d, "ReadFiles.txt"), "-o", ser, "--mesh", "4",
        "--device", "cuda"], "cqf_denoise")
    print(f"  10c cqf_denoise --mesh 4: {stats}; wall {wall:.2f} s, peak "
          f"{peak / 2**30:.2f} GiB; {_scan_note(_mesh_phases(), ha.LAUNCHES)}")
    for name, sec in sorted(phases.items(), key=lambda kv: -kv[1]):
        print(f"    {name:<30} {sec:9.3f} s")
    _, logtxt, wall, peak, phases = _mesh_cli([
        "-k", GENOME_FLAGS[1], "-i", os.path.join(d, "ReadFiles.txt"),
        "-c", ser, "--mesh", "4", "-o", ufa, "--device", "cuda"], "contiger")
    launches = _launches()
    print(f"  10c contiger --mesh 4: wall {wall:.2f} s, peak "
          f"{peak / 2**30:.2f} GiB; kernel launches over both CLIs "
          f"{launches}")
    for name, sec in sorted(phases.items(), key=lambda kv: -kv[1]):
        print(f"    {name:<30} {sec:9.3f} s")
    for line in logtxt.splitlines():
        if "[Contiger/sharded]" in line and "shards" in line:
            print("  " + line.split("] ", 1)[-1])
    # the mesh's tail (finish_parts) contracts its forest on the card like
    # the single store: one ranking, one reverse complement, one keep rule
    # and one placement
    if not all(launches.values()) or launches["contract"] != 3 or \
            launches["members"] != 1:
        raise AssertionError(f"a kernel never launched on the mesh path, or "
                             f"K9 or K10 not once: {launches}")
    k = GENOME_FLAGS[1]
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        rc = compare_contigs.main(["-k", k, ufa,
                                   os.path.join(d, "unitigs.fa")])
    print(f"  10c cli.compare_contigs ({time.time() - t0:.1f} s):")
    print("    " + buf.getvalue().strip().replace("\n", "\n    "))
    if rc != 0:
        raise AssertionError("--mesh 4 unitigs differ from phase 7's")
    cfa = os.path.join(d, "mesh4_contigs.fa")
    rc, _, mwall = _run_main(minia.main, [
        "-kmer-size", k, "-in", ufa, "-unitig", "-out", cfa])
    clens = _fasta_lengths(cfa)
    total = int(clens.sum())
    print(f"  10c unitigs = phase 7's as a set; cli.minia ({mwall:.1f} s): "
          f"{len(clens)} contigs, {total} bp, N50 {_n50(clens)}")
    if rc != 0 or abs(total - GENOME["genome_len"]) > \
            0.1 * GENOME["genome_len"]:
        raise AssertionError(f"--mesh 4 contigs total {total} bp, not "
                             f"within 10% of the genome")
    torch.cuda.empty_cache()

    # 10d: the mesh layer's own entry points at n = 8
    rc, logtxt, wall = _run_main(pmesh.main, [])
    r = pmesh.LAST
    print(f"  10d profile.mesh ({wall:.1f} s): n={r['n']}, {r['keys']} keys: "
          f"routed scan + merge {r['ms']:.3f} ms, one shard alone "
          f"{r['plain_ms']:.3f} ms, routing tax x{r['tax']:.2f}")
    got = dryrun.dryrun_multichip(8, "cuda")
    print(f"  10d dryrun_multichip(8): {got}")
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 11: the multi-process mesh.  The workers are spawned processes that
# import this file; each one runs its tasks and saves what the parent checks.

MP_GROUP_TIMEOUT = 300  # seconds a collective waits for a peer
MP_JOIN_TIMEOUT = 900  # seconds the parent waits for its workers


def spectrum_state(spec) -> dict:
    """A shard's whole counting state: store and buffer (past n_buf as
    sentinels) as int64 words, and its four counters."""
    buf = spec.buf.clone()
    buf[spec.n_buf:] = -1
    return dict(store=spec.store.cpu().numpy(), buf=buf.cpu().numpy(),
                n_main=int(spec.n_main), n_buf=int(spec.n_buf),
                ndistinct=int(spec.ndistinct), nelts=int(spec.nelts))


def _rows_of(batch, rank: int, world: int):
    """This process's rows of a global batch (its share, process-major)."""
    from sh_assembly_tpu_torch.io import fastq

    h = batch.lengths.shape[0] // world
    cut = slice(rank * h, (rank + 1) * h)
    seed = None if batch.seed_col is None else batch.seed_col[cut]
    if isinstance(batch, fastq.PackedBatch):
        return fastq.PackedBatch(batch.packed[cut], batch.nmask[cut],
                                 batch.lengths[cut], h, seed)
    return fastq.Batch(batch.codes[cut], batch.lengths[cut], h, seed)


def _mp_count(mesh, rank, world, files, sizing, rows, L, S, capacity,
              buf_capacity, threads=16):
    """Count the files' reads: every process reads them in global batches
    of ``rows`` and feeds its share through ``driver.count_stream`` (the
    scan, merge and sweep cadence of ``driver.count_sharded``)."""
    import numpy as np

    from sh_assembly_tpu_torch.io import fastq, native
    from sh_assembly_tpu_torch.parallel import driver, multihost, sharded

    sc = sharded.ShardedCounter(mesh=mesh, k=sizing.k, key_bits=sizing.hb,
                                local_capacity=capacity,
                                local_buf_capacity=buf_capacity)
    h = rows // world
    mine = (_rows_of(b, rank, world) for b in native.batches_from_files(
        files, sizing.k, "f", rows, L, n_threads=threads))

    def empty():
        return fastq.Batch(np.full((h, L), 5, np.uint8),
                           np.zeros(h, np.int32), 0)

    specs, stats = driver.count_stream(
        sc, multihost.coordinated_stream(mine, mesh, empty), sizing, h, L, S)
    out = {f"{k}": v for k, v in stats.items()}
    for gid, spec in zip(mesh.shard_ids, specs):
        for f, v in spectrum_state(spec).items():
            out[f"s{gid}_{f}"] = v
    return out


def _mp_contig(mesh, rank, world, ser, files, params, capacity, rows, Lp,
               threads=16):
    """The Contiger's collective steps (``shard_parts``) on a .ser
    spectrum: every process reads the reads in global batches and feeds its
    share."""
    from sh_assembly_tpu_torch.formats import cqf_ser
    from sh_assembly_tpu_torch.io import native
    from sh_assembly_tpu_torch.parallel import multihost, sharded, \
        sharded_contiger

    meta, keys, counts, trav = cqf_ser.read_ser(ser)
    sc = sharded.ShardedCounter(mesh=mesh, k=params.k, key_bits=meta.key_bits,
                                local_capacity=capacity,
                                local_buf_capacity=1 << 10)
    specs = sc.from_host(keys, counts.astype("int64"), traveled=trav)
    mine = (_rows_of(b, rank, world) for b in native.packed_batches_from_files(
        files, params.k, "f", rows, Lp, n_threads=threads))
    parts, saw = sharded_contiger.shard_parts(
        sc, specs, multihost.coordinated_stream(mine, mesh, None), params)
    out = dict(saw=saw)
    for gid, part in zip(mesh.shard_ids, parts):
        for f in sharded_contiger.ShardPart.__dataclass_fields__:
            out[f"s{gid}_{f}"] = getattr(part, f).cpu().numpy()
    return out


MP_TASKS = dict(count=_mp_count, contig=_mp_contig)


def _mp_worker(rank, world, local, backend, store, out_dir, tasks):
    """One process of a phase 11 job on card rank modulo the cards seen:
    joins the group, builds the mesh (a group of one gets the back end
    itself, so that one process can drive the NCCL branch), runs its tasks
    and saves each task's results, kernel launches, phases, wall and peak
    device memory."""
    import datetime

    import torch
    import torch.distributed as dist

    from sh_assembly_tpu_torch.parallel import collectives, multihost
    from sh_assembly_tpu_torch.utils import profiling

    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=MP_GROUP_TIMEOUT))
    mesh = collectives.Distributed(local, dev) if world == 1 else \
        multihost.make_global_mesh(dev, local=local)
    for name, kw in tasks:
        _reset_launches()
        profiling.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        res = MP_TASKS[name](mesh, rank, world, **kw)
        torch.cuda.synchronize()
        res.update(wall=time.time() - t0, peak=torch.cuda.max_memory_allocated(),
                   **{f"launches_{k}": v for k, v in _launches().items()},
                   **{f"phase_{k}": v.seconds
                      for k, v in profiling.GLOBAL.stats.items()},
                   **{f"calls_{k}": v.calls
                      for k, v in profiling.GLOBAL.stats.items()})
        np.savez(os.path.join(out_dir, f"{name}_{rank}.npz"), **res)
    dist.destroy_process_group()


def mp_spawn(world: int, local: int, backend: str, tasks, tag: str):
    """Run tasks in ``world`` spawned processes -> {task: [results of each
    rank]}.  A failed worker raises here with its traceback (the others are
    ended); workers still running after MP_JOIN_TIMEOUT are ended and
    raise."""
    import torch
    import torch.multiprocessing as mp

    out = os.path.join(WORK, f"mp_{tag}")
    os.makedirs(out, exist_ok=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # each worker has its own allocator
    t0 = time.time()
    ctx = mp.spawn(_mp_worker, args=(world, local, backend,
                                     os.path.join(out, "store"), out, tasks),
                   nprocs=world, join=False)
    while not ctx.join(timeout=5):
        if time.time() - t0 > MP_JOIN_TIMEOUT:
            for p in ctx.processes:
                p.kill()
            raise AssertionError(f"phase 11 {tag}: workers still running "
                                 f"after {MP_JOIN_TIMEOUT} s")
    print(f"  {tag}: {world} process(es) x {local} shard(s) over {backend} "
          f"in {time.time() - t0:.1f} s", flush=True)
    return {name: [dict(np.load(os.path.join(out, f"{name}_{r}.npz")))
                   for r in range(world)] for name, _ in tasks}


def _merged(results) -> dict:
    return {k: v for r in results for k, v in r.items()}


def _check_states(results, specs, what: str) -> None:
    """Every shard's dumped state equals the in-process mesh's."""
    got = _merged(results)
    for gid, spec in enumerate(specs):
        for f, v in spectrum_state(spec).items():
            if not np.array_equal(got[f"s{gid}_{f}"], v):
                raise AssertionError(f"{what}: shard {gid} {f} differs from "
                                     f"the in-process mesh's")


def _check_parts(results, parts, what: str) -> list:
    """Every shard's dumped store and probe part equals the in-process
    mesh's -> the dumped parts, in shard order, on the parts' device."""
    import torch

    from sh_assembly_tpu_torch.parallel import sharded_contiger

    got = _merged(results)
    fields = list(sharded_contiger.ShardPart.__dataclass_fields__)
    loaded = []
    for gid, part in enumerate(parts):
        for f in fields:
            if not np.array_equal(got[f"s{gid}_{f}"],
                                  getattr(part, f).cpu().numpy()):
                raise AssertionError(f"{what}: shard {gid} {f} differs from "
                                     f"the in-process mesh's")
        loaded.append(sharded_contiger.ShardPart(*(
            torch.from_numpy(got[f"s{gid}_{f}"]).to(part.hi.device)
            for f in fields)))
    return loaded


def _mp_report(results, tag: str) -> dict:
    """Print each process's wall, phases, peak and launches -> launches
    summed over the processes."""
    total = {}
    for rank, r in enumerate(results):
        phases = ", ".join(f"{k[6:]} {float(v):.2f} s" for k, v in
                           sorted(r.items()) if k.startswith("phase_"))
        launches = {k[9:]: int(v) for k, v in r.items()
                    if k.startswith("launches_")}
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        print(f"    {tag} rank {rank}: wall {float(r['wall']):.2f} s, peak "
              f"{int(r['peak']) / 2**30:.2f} GiB, launches {launches}; "
              f"{phases}")
    return total


def _genome_reads() -> str:
    d = os.path.join(WORK, "genome")
    if not os.path.exists(os.path.join(d, "reads.fastq")):
        os.makedirs(d, exist_ok=True)
        write_fastq(os.path.join(d, "reads.fastq"), **GENOME)
    return os.path.join(d, "reads.fastq")


def _count_setup(flags, files, n: int):
    """The CLI's sizing of ``flags`` and the in-process mesh's counter of
    n shards for it (``driver.make_counter``)."""
    from sh_assembly_tpu_torch import config as cfg
    from sh_assembly_tpu_torch.cli import cqf_denoise
    from sh_assembly_tpu_torch.parallel import driver

    sizing = cqf_denoise.counter_sizing(cqf_denoise.make_parser().parse_args(
        flags + ["-i", "ReadFiles.txt"]))
    bc = cfg.BatchConfig()
    sc = driver.make_counter(sizing, n, bc, device="cuda")
    kw = dict(files=files, sizing=sizing, rows=bc.reads_per_batch,
              L=bc.max_read_len, S=4, capacity=sc.local_capacity,
              buf_capacity=sc.local_buf_capacity)
    return sizing, bc, kw


def phase11a_count(world: int = 2, local: int = 2, backend: str = "gloo"):
    """11a: phase 7's reads counted by ``world`` processes of ``local``
    shards each, every shard bitwise equal to the in-process mesh's.
    Returns the kernel launches summed over the processes (K1 and K5)."""
    from sh_assembly_tpu_torch.parallel import driver

    n = world * local
    files = [_genome_reads()]
    sizing, bc, kw = _count_setup(GENOME_FLAGS, files, n)
    _reset_launches()
    t0 = time.time()
    _, specs, _, _, stats = driver.count_sharded(
        files, sizing, fmode="f", n_mesh=n, batch_cfg=bc, n_threads=16,
        device="cuda")
    print(f"  11a in-process mesh n={n}: {stats}, {time.time() - t0:.2f} s, "
          f"launches {_launches()}", flush=True)
    res = mp_spawn(world, local, backend, [("count", kw)],
                   f"11a_{backend}")["count"]
    _check_states(res, specs, f"11a {world}x{local} {backend}")
    for r in res:
        if {k: int(r[k]) for k in stats} != stats:
            raise AssertionError(f"11a: a process counted {r} against "
                                 f"{stats}")
    launches = _mp_report(res, "11a")
    for rank, r in enumerate(res):
        name = "count:mesh scan"
        scan = {name: (float(r[f"phase_{name}"]), int(r[f"calls_{name}"]))}
        print(f"    11a rank {rank}: "
              f"{_scan_note(scan, int(r['launches_hash_append']))}")
    if not launches["merge_dedup"] or not launches["hash_append"]:
        raise AssertionError(f"11a: K1 or K5 never launched in the workers: "
                             f"{launches}")
    print(f"  11a every shard's whole state bitwise equal to the in-process "
          f"mesh's; K1 launches over the processes "
          f"{launches['merge_dedup']}, K5 {launches['hash_append']}",
          flush=True)
    del specs
    return launches


def phase11_mesh():
    """The multi-process mesh on the card (``collectives.Distributed``):
    (a) phase 7's reads counted by 2 processes x 2 shards over gloo on
    the one card; (b) the Contiger's collective steps on phase 3's reads
    at 2 x 2 over gloo, and the host tail in this process against phase
    10a's ``contiger --mesh 4``; (c) the NCCL branch: one process of 4
    shards counts phase 3's reads and runs (b)'s steps.  Every shard is
    bitwise equal to the in-process mesh of 4 fed the same global steps.
    Returns the kernel launches summed over 11a's and 11b's processes."""
    import torch

    from sh_assembly_tpu_torch import config as cfg
    from sh_assembly_tpu_torch.formats import cqf_ser
    from sh_assembly_tpu_torch.io import native
    from sh_assembly_tpu_torch.parallel import driver, sharded_contiger

    print("== phase 11: the multi-process mesh (torch.distributed)",
          flush=True)
    launches = phase11a_count()

    # 11b: the Contiger's collective steps at 2 x 2 over gloo
    d = os.path.join(WORK, "parity")
    files = [os.path.join(d, "reads.fastq")]
    ser, fa = os.path.join(d, "mesh8_cpu.ser"), os.path.join(d,
                                                             "mesh4_cuda.fa")
    if not os.path.exists(fa):  # phase 10a's files, when run alone
        os.makedirs(d, exist_ok=True)
        if not os.path.exists(files[0]):
            write_fastq(files[0], **PARITY)
        _run_cli(PARITY_FLAGS + ["-i", os.path.join(d, "ReadFiles.txt"),
                                 "-o", ser, "--mesh", "8", "--device", "cpu"])
        _run_cli(["-k", PARITY_FLAGS[1], "-i", os.path.join(d,
                                                            "ReadFiles.txt"),
                  "-c", ser, "--mesh", "4", "-o", fa, "--device", "cuda"],
                 cli="contiger")
    meta, keys, counts, trav = cqf_ser.read_ser(ser)
    params = cfg.ContigerParams(k=int(PARITY_FLAGS[1]))
    bc = cfg.BatchConfig()
    Lp = (bc.max_read_len + 7) // 8 * 8
    sizing = cfg.CounterSizing(
        k=params.k, qb=meta.qb, hb=meta.key_bits, num_true_kmers=0,
        num_false_kmers=0, n_true_kmers=max(len(keys), 1), num_deNoise=0,
        ndistinct_for_deNoise=1 << 62, end_deNoise=False, fr=0.0)
    sc = driver.make_counter(sizing, 4, bc, device="cuda")
    specs = sc.from_host(keys, counts.astype("int64"), traveled=trav)
    ref, saw = sharded_contiger.shard_parts(
        sc, specs, native.packed_batches_from_files(
            files, params.k, "f", bc.reads_per_batch, Lp, n_threads=16),
        params)
    del specs
    contig_kw = dict(ser=ser, files=files, params=params,
                     capacity=sc.local_capacity, rows=bc.reads_per_batch,
                     Lp=Lp)
    res = mp_spawn(2, 2, "gloo", [("contig", contig_kw)], "11b")["contig"]
    parts = _check_parts(res, ref, "11b 2x2 gloo")
    got = _mp_report(res, "11b")
    contig_kernels = ("count_join", "merge128", "stage_windows",
                      "node_join", "node_probes")
    if not all(got[n] for n in contig_kernels):
        raise AssertionError(f"11b: K2, K3, K6, K7 or K8 never launched: "
                             f"{got}")
    launches.update({n: got[n] for n in contig_kernels})
    out = os.path.join(d, "mp_unitigs.fa")
    sharded_contiger.finish_parts(parts, bool(res[0]["saw"]),
                                  params).write_fasta(out)
    if open(out, "rb").read() != open(fa, "rb").read():
        raise AssertionError("11b: the unitigs.fa finished from the "
                             "processes' parts differs from contiger --mesh "
                             "4's")
    print(f"  11b stores and probe parts bitwise equal to the in-process "
          f"mesh's; unitigs.fa finished from them byte-identical to phase "
          f"10a's contiger --mesh 4 ({os.path.getsize(fa)} bytes); K2 "
          f"{got['count_join']}, K3 {got['merge128']}, K6 "
          f"{got['stage_windows']}, K7 {got['node_join']}, K8 "
          f"{got['node_probes']} launches", flush=True)
    del parts

    # 11c: the NCCL branch, one process of 4 shards on the card
    _, cbc, count_kw = _count_setup(PARITY_FLAGS, files, 4)
    _, cspecs, _, _, _ = driver.count_sharded(
        files, count_kw["sizing"], fmode="f", n_mesh=4, batch_cfg=cbc,
        n_threads=16, device="cuda")
    res = mp_spawn(1, 4, "nccl", [("count", count_kw),
                                  ("contig", contig_kw)], "11c")
    _check_states(res["count"], cspecs, "11c nccl count")
    _check_parts(res["contig"], ref, "11c nccl contig")
    _mp_report(res["count"], "11c count")
    _mp_report(res["contig"], "11c contig")
    print("  11c NCCL (1 x 4): every shard's counting state and Contiger "
          "part bitwise equal to the in-process mesh's", flush=True)
    del cspecs, ref
    torch.cuda.empty_cache()
    return launches


# K5's real shapes: profile.hot's stack (8 x 8192 reads of 160 bp, k = 47,
# key_bits 36) and the stacks phase 7's genome hands it (150 bp reads in
# rows of 152, key_bits 34)
K5_SHAPES = {"hot": (160, 47, 36), "genome": (150, 47, 34)}


def _k5_time(device, read_len: int, k: int, key_bits: int) -> dict:
    """K5 and its plain version on one real stack, bitwise, timed -> ms
    (device time a call, launches queued back to back), wrapper_ms (CUDA
    events around one wrapper call: the host's launch path included),
    plain_ms, the bound, the keys and the device time of a fill of the
    keys' buffer (store_ms)."""
    import torch

    from sh_assembly_tpu_torch.ops import hash_append_cuda as ha

    pk, nm, ln, Lp = k5_real(device, read_len)
    n = ln.numel() * (Lp - k + 1)
    bufs = [torch.full((n,), -1, dtype=torch.int64, device=device)
            for _ in range(2)]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    run = [lambda f=f, b=b: f(b, 0, zero, ln, k, key_bits, packed=pk,
                              nmask=nm)
           for f, b in ((ha.hash_append_cuda, bufs[0]),
                        (ha.hash_append_plain, bufs[1]))]
    got, want = run[0](), run[1]()
    torch.cuda.synchronize()
    if int(got) != int(want) or not torch.equal(*bufs):
        raise AssertionError(
            f"K5 != plain version at {read_len} bp: nelts {int(got)} vs "
            f"{int(want)}, {int((bufs[0] != bufs[1]).sum())} keys differ")
    wrapper_ms, plain_ms = _time_ms(run[0], 20), _time_ms(run[1], 3)
    ms = _queued_ms(run[0], 20)
    # what writing the keys alone takes on this card: a fill of the buffer
    store_ms = _queued_ms(lambda: bufs[1].fill_(-1), 20)
    # keys written once, the packed bases, N mask and lengths read once;
    # a rolling hash needs two 64-bit rotations and four XORs a key for
    # both strands, a min and a mask: 16 32-bit operations at the least
    moved = 8 * n + pk.numel() + nm.numel() + 4 * ln.numel()
    return dict(ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                library_ms=None, keys=n,
                nelts=int(got), moved=moved, store_ms=store_ms,
                **bound(moved, 16 * n))


def phase14_k5(device):
    """K5 against its plain version, bitwise, on the CPU test's cases and
    more, then at its two real shapes, timed.  Returns (err, timing)."""
    import torch

    from sh_assembly_tpu_torch.ops import hash_append_cuda as ha

    print("== phase 14: K5 (hash + append) against its plain version",
          flush=True)
    n = 0
    before = ha.LAUNCHES
    for case in k5_cases(device):
        k5_compare(*case)
        n += 1
    launches = ha.LAUNCHES - before
    print(f"  {n} cases identical, the words around each range untouched "
          f"({launches} launches; k = 1, 21, 25, 31, 33, 47, 63, codes and "
          f"packed rows, odd offsets, rows of 37 to {K5_LONG_ROW} bases, "
          f"rotations wrapping at 64, 65 and 160, segments with Ns on their "
          f"seams, empty and short rows)")
    if launches != n:
        raise AssertionError(f"{launches} K5 launches for {n} cases")
    timing = {}
    for shape, (read_len, k, kb) in K5_SHAPES.items():
        t = timing[shape] = _k5_time(device, read_len, k, kb)
        print(f"  {shape} shape, 8 x 8192 reads of {read_len} bp, k={k}, "
              f"key_bits {kb}: identical ({t['keys']} keys, {t['nelts']} "
              f"valid); K5 device {t['ms']:.4f} ms (a wrapper call "
              f"{t['wrapper_ms']:.4f} ms), plain {t['plain_ms']:.3f}"
              f" ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}, "
              f"{t['moved'] / 1e6:.2f} MB), a fill of the keys' buffer "
              f"{t['store_ms']:.4f} ms of device time", flush=True)
    torch.cuda.empty_cache()
    return 0, timing


# K6's real shapes: the stacks phase 7's genome hands it (8 x 8192 reads of
# 150 bp in rows of 152, k = 47, key_bits 34, each read's middle window its
# seed) and the bench's stage-2 stack (8 x 8192 rows of 160, key_bits 33, no
# seeds)
K6_SHAPES = {"genome": (150, 47, 34, True), "stage2": (160, 47, 33, False)}


def _k6_time(device, read_len: int, k: int, key_bits: int,
             seeded: bool) -> dict:
    """K6 and its plain version on one real stack, bitwise, timed -> ms
    (device time a call, launches queued back to back), wrapper_ms (CUDA
    events around one wrapper call: the host's launch path included),
    plain_ms, the bound, the windows and the device time of a fill of the
    four outputs (store_ms)."""
    import torch

    from sh_assembly_tpu_torch.ops import stage_cuda

    pk, nm, ln, Lp = k5_real(device, read_len)
    pk, nm, ln = pk.reshape(-1, Lp // 4), nm.reshape(-1, Lp // 8), \
        ln.reshape(-1)
    R, W = ln.numel(), Lp - k + 1
    sc = torch.full((R,), (read_len - k) // 2 if seeded else -1,
                    dtype=torch.int32, device=device)
    n = R * W
    outs = [([torch.empty(n, dtype=torch.int64, device=device)
              for _ in range(3)] + [torch.empty(n, dtype=torch.uint8,
                                                device=device)])
            for _ in range(2)]
    run = [lambda f=f, o=o: f(*o, 0, pk, nm, ln, sc, k, key_bits)
           for f, o in ((stage_cuda.stage_windows_cuda, outs[0]),
                        (stage_cuda.stage_windows_plain, outs[1]))]
    run[0](), run[1]()
    torch.cuda.synchronize()
    for f, a, b in zip(("hi", "lo", "key", "seed"), *outs):
        if not torch.equal(a, b):
            raise AssertionError(
                f"K6 != plain version at {read_len} bp: {f} differs in "
                f"{int((a != b).sum())} of {n} windows")
    live = int((outs[0][2] != -1).sum())
    seeds = int(outs[0][3].sum())
    wrapper_ms, plain_ms = _time_ms(run[0], 20), _time_ms(run[1], 3)
    ms = _queued_ms(run[0], 20)
    # what writing the four outputs alone takes on this card
    store_ms = _queued_ms(lambda: [t.fill_(0) for t in outs[1]], 20)
    # the outputs written once (three words and a flag a window), the
    # packed bases, N mask, lengths and seed columns read once; a window
    # needs at least its rolling hash (16 32-bit operations, as K5) and
    # two rolled 128-bit words and their compare (16 more)
    moved = 25 * n + pk.numel() + nm.numel() + 8 * R
    return dict(ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                library_ms=None, windows=n, live=live, seeds=seeds,
                moved=moved, store_ms=store_ms, **bound(moved, 32 * n))


def phase15_k6(device):
    """K6 against its plain version, bitwise, on the CPU test's geometries
    and its tiling's edges, then at its two real shapes, timed.  Returns
    (err, timing)."""
    import torch

    from sh_assembly_tpu_torch.ops import stage_cuda

    print("== phase 15: K6 (collect staging) against its plain version",
          flush=True)
    n = 0
    before = stage_cuda.LAUNCHES
    for case in k6_cases(device):
        k6_compare(*case)
        n += 1
    launches = stage_cuda.LAUNCHES - before
    print(f"  {n} cases identical, the entries around each range untouched "
          f"({launches} launches; k = 1, 8, 21, 31, 32, 33, 47, 63, rows of 8 "
          f"to {K5_LONG_ROW} bases, both key rules, odd offsets, Ns, pad, "
          f"empty and short rows, seed columns in and out of range, segments "
          f"with Ns and seeds on their seams)")
    if launches != n:
        raise AssertionError(f"{launches} K6 launches for {n} cases")
    timing = {}
    for shape, (read_len, k, kb, seeded) in K6_SHAPES.items():
        t = timing[shape] = _k6_time(device, read_len, k, kb, seeded)
        print(f"  {shape} shape, 8 x 8192 reads of {read_len} bp, k={k}, "
              f"key_bits {kb}: identical ({t['windows']} windows, "
              f"{t['live']} keyed, {t['seeds']} seeds); K6 device "
              f"{t['ms']:.4f} ms (a wrapper call {t['wrapper_ms']:.4f} ms), "
              f"plain {t['plain_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}, {t['moved'] / 1e6:.2f} MB), a fill of the "
              f"four outputs {t['store_ms']:.4f} ms of device time",
              flush=True)
    torch.cuda.empty_cache()
    return 0, timing


def _k7_later(device, chi, clo, real, m, pad, k, kb, reps=5) -> dict:
    """K7 at a later closure round's shape: a table built on the padded
    store (chi, clo) with its last m real rows as pad, those m rows
    appended, then the 16 closure probes of a frontier of them padded to
    ``pad`` probed; append and probe timed by CUDA events behind a spin
    kernel, a fresh table a rep, the first rep held against
    ``join2_plain`` on the store and timing it -> dict."""
    import torch

    from sh_assembly_tpu_torch.ops import kmerpack as kp, node_join_cuda, \
        probe_cuda

    fh = torch.full((pad,), -1, dtype=torch.int64, device=device)
    fl = fh.clone()
    fh[:m], fl[:m] = chi[real - m:real], clo[real - m:real]
    _, qh, ql, _ = probe_cuda.node_probes_cuda(fh, fl, k, kb, "closure")
    qh, ql = qh.reshape(-1), ql.reshape(-1)
    bh, bl = chi.clone(), clo.clone()
    bh[real - m:real], bl[real - m:real] = -1, -1
    times, plain_ms = [], None
    for rep in range(reps + 1):
        table = node_join_cuda.NodeTable().build(bh.clone(), bl.clone(),
                                                 real - m)
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)  # the host queues both calls
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        table.append(fh[:m], fl[:m], real - m)
        ev[1].record()
        got = table.probe(qh, ql)
        ev[2].record()
        torch.cuda.synchronize()
        if rep == 0:
            box = []
            plain_ms = _time_ms(lambda: box.append(kp.join2_plain(
                chi, clo, qh, ql)), 1)
            if not (torch.equal(table.hi, chi) and torch.equal(
                    table.lo, clo) and torch.equal(got, box.pop())):
                raise AssertionError(f"K7 later round ({m} appended, {pad} "
                                     f"frontier) differs from join2_plain")
        else:
            times.append((ev[0].elapsed_time(ev[1]),
                          ev[1].elapsed_time(ev[2])))
        del table, got
    append_ms, probe_ms = sorted(times, key=sum)[len(times) // 2]
    Q = qh.numel()
    moved = 16 * m + 20 * Q  # the appended rows and the queries read once
    return dict(ms=append_ms + probe_ms, append_ms=append_ms,
                probe_ms=probe_ms, plain_ms=plain_ms, library_ms=None,
                moved=moved, appended=m, queries=Q,
                **bound(moved, 2 * 10 * (m + Q)))


# K7 and K8 at their real shapes: profile.stage2's 2^24 node k-mers (k =
# 47, key_bits 36 at its 2^28 slots), phase 7's padded store for the
# closure (its 12,232,221 nodes, then sentinel pad rows to 2^24)
PROBE_SHAPE = dict(log2_n=24, k=47, key_bits=36, closure_real=12_232_221)


def _probe_time(kern, plain, compare, reps: int = 10):
    """A kernel call and its plain version on the card: the plain result
    (one call, timed by CUDA events), the kernel's held against it
    bitwise by ``compare``, the kernel's device time (``_queued_ms``) and a
    wrapper call's -> (ms, wrapper_ms, plain_ms)."""
    import torch

    box = []
    plain_ms = _time_ms(lambda: box.append(plain()), 1)
    got = kern()
    torch.cuda.synchronize()
    compare(got, box.pop())
    del got
    torch.cuda.empty_cache()
    return _queued_ms(kern, reps), _time_ms(kern, 3), plain_ms


def _same(what):
    """A compare for _probe_time: tuples of tensors (or None) bitwise."""
    import torch

    def check(got, want):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for i, (a, b) in enumerate(zip(got, want)):
            if (a is None) != (b is None) or (a is not None and not (
                    a.dtype == b.dtype and torch.equal(a, b))):
                raise AssertionError(f"{what}: output {i} differs from the "
                                     f"plain version")
    return check


def phase16_k7_k8(device):
    """K7 and K8 against their plain versions, bitwise, on their edge cases
    and at their real shapes, timed; then the split of one
    build_oriented_graph call at phase 7's shape.  Returns the timing of
    each kernel."""
    import torch

    from sh_assembly_tpu_torch.models import contiger
    from sh_assembly_tpu_torch.ops import bits, kmerpack as kp, \
        node_join_cuda, probe_cuda, spectrum as sp
    from sh_assembly_tpu_torch.profile import stage2

    print("== phase 16: K7 (node join) and K8 (node probes) against their "
          "plain versions", flush=True)
    before = node_join_cuda.LAUNCHES
    n7 = found = launched = 0
    for case in k7_cases(device):
        found += k7_compare(*case)
        n7 += 1
        # a table built for the call (no kernel for an empty one) and probed
        launched += (case[3].numel() > 0) * (1 + (case[1].numel() > 0))
    if node_join_cuda.LAUNCHES - before != launched:
        raise AssertionError(f"{node_join_cuda.LAUNCHES - before} K7 "
                             f"launches where {launched} were due")
    print(f"  K7: {n7} cases identical to join2_plain ({found} queries "
          f"found; a table of one pair repeated, padded stores, N and Q not "
          f"powers of two, Q = 0, N = 1, N = 0, tables in random order with "
          f"repeats and sentinels at k = {PROBE_KS}, warps of several equal "
          f"groups, 2^20 rows against 3 x 2^20 queries)")
    steps = []
    for name, *case in k7_growth():
        steps.append(f"{name} {k7_grow_compare(device, name, *case)}")
    print(f"  K7 table grown as the closure grows its store: every step "
          f"identical to join2_plain on the padded rows ({', '.join(steps)} "
          f"steps: appends inside the extent, filling it exactly, crossing "
          f"it, full at the first build, appended rows repeating earlier "
          f"ones, sentinel queries)")
    before = probe_cuda.LAUNCHES
    n8 = launched = 0
    for case in k8_cases(device):
        k8_compare(*case)
        n8 += 1
        launched += case[1].numel() > 0
    if probe_cuda.LAUNCHES - before != launched:
        raise AssertionError(f"{probe_cuda.LAUNCHES - before} K8 launches "
                             f"for {launched} cases with nodes")
    print(f"  K8: {n8} cases identical to node_probes_plain (k = 1 and "
          f"{PROBE_KS}, both modes, key_bits 22, 34, 63, padding rows, "
          f"poly-A and poly-T, N = 1 and 0)")

    s = PROBE_SHAPE
    k, kb = s["k"], s["key_bits"]
    hp, lp = stage2.node_kmers(s["log2_n"])
    hi, lo = bits.from_u64_np(hp, device), bits.from_u64_np(lp, device)
    del hp, lp
    N = hi.numel()
    chi, clo = hi.clone(), lo.clone()
    chi[s["closure_real"]:] = -1
    clo[s["closure_real"]:] = -1
    timing = {}
    for mode, (th, tl) in (("graph", (hi, lo)), ("closure", (chi, clo))):
        nk, P, nf = probe_cuda.ROWS[mode]
        ms, wms, pms = _probe_time(
            lambda: probe_cuda.node_probes_cuda(th, tl, k, kb, mode),
            lambda: probe_cuda.node_probes_plain(th, tl, k, kb, mode),
            _same(f"K8 {mode} at {N} nodes"))
        # a node read once, its key, word and flip rows written once
        moved = N * (16 + 8 * nk + 16 * P + 4 * nf)
        # 64-bit operations at the least: 4 a base of the node's hash, 24 a
        # probe (its hash pair, min and mask, the shifted words, their
        # reverse complement and the compare), two 32-bit ones each
        ops = 2 * N * (4 * k + 24 * P)
        t8 = dict(ms=ms, wrapper_ms=wms, plain_ms=pms, library_ms=None,
                  moved=moved, nodes=N, **bound(moved, ops))
        _, qh, ql, _ = probe_cuda.node_probes_cuda(th, tl, k, kb, mode)
        qh, ql = qh.reshape(-1), ql.reshape(-1)
        Q = qh.numel()
        ms, wms, pms = _probe_time(
            lambda: node_join_cuda.node_join(th, tl, qh, ql),
            lambda: kp.join2_plain(th, tl, qh, ql),
            _same(f"K7 {mode}: {N} rows, {Q} queries"))
        hits = int((node_join_cuda.node_join(th, tl, qh, ql) >= 0).sum())
        moved7 = 16 * N + 20 * Q
        t7 = dict(ms=ms, wrapper_ms=wms, plain_ms=pms, library_ms=None,
                  moved=moved7, rows=N, queries=Q, found=hits,
                  **bound(moved7, 2 * 10 * (N + Q)))
        # its parts: a build of the table as the closure builds it (the
        # real rows and the pad's last row) and a probe of the built table
        real = s["closure_real"] if mode == "closure" else N
        table = node_join_cuda.NodeTable().build(th, tl, real)
        t7.update(build_ms=_queued_ms(lambda: table.build(th, tl, real), 10),
                  probe_ms=_queued_ms(lambda: table.probe(qh, ql), 10))
        del qh, ql, table
        torch.cuda.empty_cache()
        timing[mode] = dict(node_probes=t8, node_join=t7)
        for name, t in (("K8 node_probes", t8), ("K7 node_join", t7)):
            print(f"  {name}, {mode} shape ({N} nodes"
                  + (f", {t['queries']} queries, {t['found']} found"
                     if "queries" in t else "")
                  + f"): identical; device {t['ms']:.4f} ms (a wrapper call "
                  f"{t['wrapper_ms']:.4f} ms), plain {t['plain_ms']:.3f} ms, "
                  f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}, "
                  f"{t['moved'] / 1e9:.3f} GB)", flush=True)
        print(f"    K7 {mode}: a build {t7['build_ms']:.4f} ms, a probe of "
              f"the built table {t7['probe_ms']:.4f} ms", flush=True)

    # K7 as the main path runs it after round 1: later closure rounds
    # (phase 7's frontiers padded to 2^14 and 2^22) append to the table and
    # probe it; the graph probes the closure's table, no build
    R = s["closure_real"]
    for pad, m in ((1 << 14, 5_000), (1 << 22, 50_000)):
        t = _k7_later(device, chi, clo, R, m, pad, k, kb)
        print(f"  K7 later closure round ({m} phantoms appended to {R - m} "
              f"real rows, {t['queries']} queries of a frontier padded to "
              f"{pad}): identical; device {t['ms']:.4f} ms (append "
              f"{t['append_ms']:.4f}, probe {t['probe_ms']:.4f}), plain "
              f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}, {t['moved'] / 1e9:.4f} GB)", flush=True)
        if pad == 1 << 14:
            timing["closure"]["node_join"]["later"] = t
    _, qh, ql, _ = probe_cuda.node_probes_cuda(chi, clo, k, kb, "graph")
    qh, ql = qh.reshape(-1), ql.reshape(-1)
    table = node_join_cuda.NodeTable().build(chi, clo, R)
    if not torch.equal(table.probe(qh, ql), kp.join2_plain(chi, clo, qh, ql)):
        raise AssertionError("K7: the graph's probe of phase 7's store "
                             "differs from join2_plain")
    graph_probe = _queued_ms(lambda: table.probe(qh, ql), 10)
    timing["graph"]["node_join"]["main_graph_probe_ms"] = graph_probe
    print(f"  K7 the graph's probe of phase 7's store, the closure's table "
          f"({R} real rows, {qh.numel()} queries): identical; device "
          f"{graph_probe:.4f} ms", flush=True)
    del qh, ql, table
    torch.cuda.empty_cache()

    # the split of one build_oriented_graph call (and one closure round) at
    # phase 7's shape, against profile.stage2's spectrum
    spec = stage2.build_spectrum(hi, lo, kb, 1 << 28, 1 << 26)
    torch.cuda.synchronize()
    probes = probe_cuda.node_probes(hi, lo, k, kb, "graph")
    keys, qh, ql = probes[0], probes[1].reshape(-1), probes[2].reshape(-1)
    flat = keys.reshape(-1)
    split = dict(
        probes=_time_ms(lambda: probe_cuda.node_probes(hi, lo, k, kb,
                                                       "graph"), 3),
        node_join=_time_ms(lambda: kp.join2(hi, lo, qh, ql), 3),
        count_join=_time_ms(lambda: sp.query_join_auto(spec, keys, kb), 3),
        count_sort=_time_ms(lambda: torch.sort(bits.flip(flat)), 3))
    del probes, keys, qh, ql, flat
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    graph = contiger.build_oriented_graph(spec, hi, lo, k, kb, 2)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del graph
    split["total"] = _time_ms(
        lambda: contiger.build_oriented_graph(spec, hi, lo, k, kb, 2), 3)
    rest = split["total"] - split["probes"] - split["node_join"] - \
        split["count_join"]
    closure = _time_ms(lambda: contiger.phantom_candidates(
        spec, chi, clo, chi, clo, k, kb, 2), 1)
    print(f"  build_oriented_graph at {N} nodes ({split['total']:.2f} ms, "
          f"peak {peak / 2**30:.2f} GiB above its inputs): probes "
          f"{split['probes']:.2f} ms, node join {split['node_join']:.2f} ms, "
          f"count join {split['count_join']:.2f} ms (of which the library "
          f"sort {split['count_sort']:.2f} ms), the rest {rest:.2f} ms; "
          f"phantom_candidates over the padded store (closure round 1) "
          f"{closure:.2f} ms", flush=True)
    del spec, hi, lo, chi, clo
    torch.cuda.empty_cache()
    return timing


# K9 at the oriented extent of the E. coli cell (4.8 M real nodes padded to
# 2^23): a mirrored forest of paths of 1 to 200 nodes, some of 20,000, and
# cycles, 43 % of the nodes padding rows
K9_SHAPE = dict(seed=96, nodes=1 << 23, k=47, lens=(1, 200),
                long_paths=(20_000,) * 8, cycles=64, pad=0.43)


def phase17_k9(device):
    """K9 against its plain twins, bitwise, on its cases and at the cell's
    extent, timed there beside them.  Returns its timing."""
    import torch

    from sh_assembly_tpu_torch.ops import bits, contract_cuda
    from sh_assembly_tpu_torch.ops import kmerpack as kp

    print("== phase 17: K9 (contraction) against its plain twins", flush=True)

    def tensors(cn, hi, lo):
        return (torch.from_numpy(cn).to(device), bits.from_u64_np(hi, device),
                bits.from_u64_np(lo, device))

    def twins(cn, hi, lo, k):  # by name, on the card
        head, dist, tail_of, n_bad = contract_cuda.rank_plain(cn)
        rhi, rlo = kp.revcomp_packed(hi, lo, k)
        keep = contract_cuda.keep_plain(head, tail_of, hi, lo, rhi, rlo)
        return head, dist, tail_of, keep, rhi, rlo, n_bad

    before = contract_cuda.LAUNCHES
    names = []
    for name, cn, hi, lo, k in k9_cases(large=True):
        want = k9_host(cn, hi, lo, k)
        args = tensors(cn, hi, lo)
        k9_compare(name, contract_cuda.contract(*args, k), want)
        k9_compare(name, twins(*args, k), want)
        names.append(name)
    if contract_cuda.LAUNCHES - before != 3 * len(names):
        raise AssertionError(f"{contract_cuda.LAUNCHES - before} calls into "
                             f"K9's library for {len(names)} forests")
    print(f"  K9: {len(names)} forests identical to the plain twins on the "
          f"CPU and on the card ({', '.join(names)})")

    s = K9_SHAPE
    k = s["k"]
    cn, hi, lo = k9_forest(s["seed"], s["nodes"], k, lens=s["lens"],
                           long_paths=s["long_paths"], cycles=s["cycles"],
                           pad=s["pad"], mirror=True)
    args = tensors(cn, hi, lo)
    M, Np = len(cn), len(hi)
    heads = []

    def compare(got, plain):
        want = k9_numpy(plain)
        heads.append(int((want[0] == np.arange(M)).sum()))
        k9_compare("the cell's extent", got, want)

    ms, wms, pms = _probe_time(lambda: contract_cuda.contract(*args, k),
                               lambda: twins(*args, k), compare)
    head, _, tail_of, _ = contract_cuda.rank_cuda(args[0])
    rhi, rlo = contract_cuda.revcomp_cuda(args[1], args[2], k)
    parts = dict(
        rank_ms=_queued_ms(lambda: contract_cuda.rank_cuda(args[0]), 10),
        revcomp_ms=_queued_ms(
            lambda: contract_cuda.revcomp_cuda(args[1], args[2], k), 10),
        keep_ms=_queued_ms(lambda: contract_cuda.keep_cuda(
            head, tail_of, args[1], args[2], rhi, rlo), 10))
    # next read once; head, dist and keep written once; the node words read
    # once and their reverse complements written once
    moved = M * (4 + 4 + 4 + 1) + Np * (16 + 16)
    t9 = dict(ms=ms, wrapper_ms=wms, plain_ms=pms, library_ms=None,
              **parts, moved=moved, oriented_nodes=M,
              heads=heads[0], **bound(moved, 0))
    del args, head, tail_of, rhi, rlo
    torch.cuda.empty_cache()
    print(f"  K9 at the cell's extent ({M} oriented nodes, {t9['heads']} "
          f"heads): identical; device {ms:.4f} ms (ranking "
          f"{parts['rank_ms']:.4f}, reverse complements "
          f"{parts['revcomp_ms']:.4f}, keep rule {parts['keep_ms']:.4f}; a "
          f"wrapper call {wms:.4f} ms), plain {pms:.3f} ms, bound "
          f"{t9['bound_ms']:.4f} ms ({t9['bound_by']}, {moved / 1e9:.3f} GB)",
          flush=True)
    return t9


def phase18_k10(device, main_launches: int):
    """K10 against its plain twin, bitwise, on its cases and at phase 17's
    extent, timed there beside it; a forest with a padding row on a kept
    path must raise.  Returns its timing, with ``main_launches``, its
    launches on phase 7's main path."""
    import torch

    from sh_assembly_tpu_torch.ops import members_cuda

    print("== phase 18: K10 (members) against its plain twin", flush=True)
    before = members_cuda.LAUNCHES
    names = []
    for name, *case in k10_cases():
        want = k10_host(*case)
        args = k10_inputs(*case, device)
        k10_compare(name, members_cuda.members(*args, case[-1]), want)
        k10_compare(name, members_cuda.members_plain(*args, case[-1]), want)
        names.append(name)
    if members_cuda.LAUNCHES - before != len(names):
        raise AssertionError(f"{members_cuda.LAUNCHES - before} placements "
                             f"through K10's library for {len(names)} cases")
    args = list(k10_inputs(*dict((c[0], c[1:]) for c in k10_cases())[
        "mirrored_k47"], device))
    head, dist, keep = args[0], args[1], args[3]
    a = int(torch.nonzero(keep[head.long()] & (dist > 0))[0, 0])
    args[8] = args[8].clone()
    args[8][a >> 1] = False
    try:
        members_cuda.members_cuda(*args, 47)
    except ValueError as e:
        print(f"  a padding row on a kept path: refused ({e})")
    else:
        raise AssertionError("K10 placed a path holding a padding row")
    print(f"  K10: {len(names)} cases identical to the plain twin on the CPU "
          f"and on the card ({', '.join(names)})")

    name, *case = next(c for c in k10_cases(large=True)
                       if c[0] == "cell_extent")
    cn, hi, lo, real, counts, k = case
    args = k10_inputs(*case, device)
    M, Np = len(cn), len(hi)
    want = k10_numpy(members_cuda.members_plain(*args, k))
    k10_compare("the cell's extent", members_cuda.members_cuda(*args, k),
                want)
    plain_ms = _time_ms(lambda: members_cuda.members_plain(*args, k), 3)
    head, dist, tail_of, keep, *_, real_t, _ = args
    tot, _, _ = members_cuda.count_cuda(keep, real_t, dist, tail_of)
    n_mem, n_paths = tot.tolist()

    def launches():  # the two entries, queued with the totals known
        _, bs, bf = members_cuda.count_cuda(keep, real_t, dist, tail_of)
        members_cuda.place_cuda(*args, k, bs, bf, n_mem, n_paths)

    ms = _queued_ms(launches, 10)
    wms = _time_ms(lambda: members_cuda.members_cuda(*args, k), 3)
    # keep, head and dist read, off written and read (17 B an oriented
    # slot); real read; each member's words and count read and its row
    # written (45 B); each path's start and head written
    moved = 17 * M + Np + 45 * n_mem + 8 * n_paths
    t10 = dict(ms=ms, wrapper_ms=wms, plain_ms=plain_ms, library_ms=None,
               moved=moved, oriented_nodes=M, members=n_mem, paths=n_paths,
               main_launches=main_launches, **bound(moved, 0))
    del args, head, dist, tail_of, keep, real_t
    torch.cuda.empty_cache()
    print(f"  K10 at the cell's extent ({M} oriented nodes, {n_mem} members "
          f"of {n_paths} kept paths): identical; device {ms:.4f} ms (a "
          f"wrapper call {wms:.4f} ms, its two reads included), plain "
          f"{plain_ms:.3f} ms, bound {t10['bound_ms']:.4f} ms "
          f"({t10['bound_by']}, {moved / 1e9:.3f} GB); {main_launches} "
          f"placement(s) on phase 7's main path", flush=True)
    return t10


# the kept paths of a yeast-cell job (scer.pipeline.30x), as their lengths
# fall: (least length, largest length, paths), from one job's K11 inputs on
# an H100 (179,684 paths, 12,452,582 members, the longest 2,274)
YEAST_PATHS = ((1, 1, 105_837), (2, 3, 6_550), (4, 7, 2_338),
               (8, 15, 4_112), (16, 31, 6_887), (32, 32, 370),
               (33, 63, 10_058), (64, 127, 11_673), (128, 255, 14_894),
               (256, 511, 12_152), (512, 1023, 4_390), (1024, 2047, 420),
               (2048, 2274, 3))


def yeast_lengths(seed: int = 190) -> np.ndarray:
    """Path lengths drawn from YEAST_PATHS: each bin's paths, lengths
    uniform within the bin."""
    rng = np.random.default_rng(seed)
    lens = [rng.integers(lo, hi, n, endpoint=True)
            for lo, hi, n in YEAST_PATHS]
    return rng.permutation(np.concatenate(lens))


def _k11_time(device, tag, counts, starts, ai, seed, smin, smax) -> dict:
    """K11 against its plain twin on the card at one extent, bitwise, and
    timed beside it and its byte bound."""
    import torch

    from sh_assembly_tpu_torch.ops import path_stats_cuda as ps

    args = (counts, starts, ai, seed, smin, smax)
    want = tuple(t.cpu().numpy() for t in ps.path_stats_plain(*args))
    k11_compare(tag, ps.path_stats_cuda(*args), want)
    ms = _queued_ms(lambda: ps.path_stats_cuda(*args), 10)
    wms = _time_ms(lambda: ps.path_stats_cuda(*args), 5)
    pms = _time_ms(lambda: ps.path_stats_plain(*args), 3)
    M, P = counts.numel(), starts.numel()
    lens = torch.diff(starts.long(), append=torch.tensor([M], device=device))
    hits = int(((counts >= smin) & (counts <= smax)).sum())
    # each member's count read; where it lies in the solid range, its
    # oriented index and its node's seed byte; each path's start read and
    # its median, sum and flag written (17 B)
    moved = 4 * M + 5 * hits + 4 * P + 17 * P
    t = dict(ms=ms, wrapper_ms=wms, plain_ms=pms, library_ms=None,
             members=M, paths=P, max_len=int(lens.max()),
             warp_paths=int((lens <= ps.limits()["warp_max"]).sum()),
             moved=moved, **bound(moved, 0))
    print(f"  K11 at {tag} ({M} members of {P} paths, {t['warp_paths']} of "
          f"them a warp's, the longest {t['max_len']}): identical; device "
          f"{ms:.4f} ms (a wrapper call {wms:.4f} ms), plain {pms:.3f} ms, "
          f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}, "
          f"{moved / 1e6:.1f} MB)", flush=True)
    return t


def _links_time(device, tag, fhi, flo, thi, tlo, k) -> dict:
    """The link join through K7 against its plain twin on the card at one
    extent, bitwise, and timed beside it and its byte bound."""
    from sh_assembly_tpu_torch.ops import kmerpack as kp, links_cuda

    args = (fhi, flo, thi, tlo, *kp.revcomp_packed(fhi, flo, k),
            *kp.revcomp_packed(thi, tlo, k), k)
    want = tuple(v.cpu().numpy() for v in links_cuda.links_plain(*args))
    links_compare(tag, links_cuda.links_cuda(*args), want)
    ms = _queued_ms(lambda: links_cuda.links_cuda(*args), 10)
    wms = _time_ms(lambda: links_cuda.links_cuda(*args), 5)
    pms = _time_ms(lambda: links_cuda.links_plain(*args), 3)
    P2 = fhi.numel()
    # the ends and their reverse complements read (64 B a path), the two
    # table rows written and read once (64 B), the 16 signed ids written
    moved = P2 * (64 + 64 + 4 * links_cuda.PROBES)
    found = sum(int((v != 0).sum()) for v in want)
    t = dict(ms=ms, wrapper_ms=wms, plain_ms=pms, library_ms=None, paths=P2,
             found=found, moved=moved, **bound(moved, 0))
    print(f"  link join at {tag} ({P2} paths, {links_cuda.PROBES * P2} "
          f"probes, {found} found): identical; device {ms:.4f} ms (a "
          f"wrapper call {wms:.4f} ms), plain {pms:.3f} ms, bound {t['bound_ms']:.4f} ms "
          f"({t['bound_by']}, {moved / 1e6:.1f} MB)", flush=True)
    return t


def phase19_k11_links(device, main_launches: dict):
    """K11 and the link join through K7 against their plain twins, bitwise,
    on their cases; then at phase 17's extent (K10's members of its forest)
    and at the yeast cell's (``YEAST_PATHS``), timed beside the twins and
    their byte bounds.  Returns their timing, with ``main_launches``, their
    launches on phase 7's main path."""
    import torch

    from sh_assembly_tpu_torch.ops import bits, links_cuda, members_cuda
    from sh_assembly_tpu_torch.ops import path_stats_cuda as ps

    print("== phase 19: K11 (medians) and the link join (K7) against their "
          f"plain twins; K11's limits {ps.limits()}", flush=True)
    before = ps.LAUNCHES, links_cuda.LAUNCHES
    names, joins = [], 0
    for name, *case in k11_cases():
        want = k11_host(*case)
        args = k11_inputs(*case[:4], device)
        k11_compare(name, ps.path_stats(*args, *case[4:]), want)
        k11_compare(name, ps.path_stats_plain(*args, *case[4:]), want)
        names.append(name)
    for name, *case in links_cases():
        want = links_host(*case)
        args = links_inputs(*case, device)
        links_compare(name, links_cuda.links(*args, case[-1]), want)
        links_compare(name, links_cuda.links_plain(*args, case[-1]), want)
        names.append(name)
        joins += len(case[0]) > 0
    if (ps.LAUNCHES - before[0], links_cuda.LAUNCHES - before[1]) != \
            (len(names) - sum(1 for _ in links_cases()), joins):
        raise AssertionError("K11 or the link join did not launch once a "
                             "case")
    print(f"  {len(names)} cases identical to the plain twins on the CPU and "
          f"on the card ({', '.join(names)})")

    # phase 17's extent: K10's members of its forest, a seed mask over its
    # nodes; the link join on every kept path's ends
    _, *case = next(c for c in k10_cases(large=True) if c[0] == "cell_extent")
    k = case[-1]
    ai, ohi, olo, _, counts, starts, _ = members_cuda.members(
        *k10_inputs(*case, device), k)
    g = torch.Generator(device=device).manual_seed(19)
    seed = torch.rand(len(case[1]), device=device, generator=g) < 0.3
    t11 = dict(cell=_k11_time(device, "phase 17's extent", counts, starts,
                              ai, seed, 10, 50))
    last = torch.cat([starts[1:].long(),
                      torch.tensor([ai.numel()], device=device)]) - 1
    first = starts.long()
    tl = dict(cell=_links_time(device, "phase 17's extent", ohi[first],
                               olo[first], ohi[last], olo[last], k))
    del ai, ohi, olo, counts, starts, seed, first, last
    # the yeast cell's extent: its paths' lengths, counts of a 30x job; the
    # link join on the ends of as many pieces of a genome (the keep rule
    # leaves one path of each mirror pair)
    lens = yeast_lengths()
    c, st, a, sd = k11_paths(191, lens)
    t11["yeast"] = _k11_time(device, "the yeast cell's extent",
                             *k11_inputs(c, st, a, sd, device), 10, 50)
    ends = links_ends(192, 47, n=len(lens), palindromes=20)
    tl["yeast"] = _links_time(device, "the yeast cell's extent",
                              *(bits.from_u64_np(e, device) for e in ends),
                              47)
    torch.cuda.empty_cache()
    print(f"  launches on phase 7's main path: {main_launches}", flush=True)
    return dict(k11=t11, links=tl, main_launches=main_launches)


def phase12_profiles():
    """The profiling entry points of the counting hot path and the
    Contiger at their defaults (``profile.{entry,hot,collect,stage2}``)."""
    from sh_assembly_tpu_torch.profile import collect, entry, hot, stage2

    print("== phase 12: profile.entry, .hot, .collect and .stage2", flush=True)
    for name, mod in (("entry", entry), ("hot", hot), ("collect", collect),
                      ("stage2", stage2)):
        _reset_launches()
        rc, _, wall = _run_main(mod.main, [])
        if rc != 0:
            raise AssertionError(f"profile.{name} exited {rc}")
        print(f"  profile.{name} ({wall:.1f} s): {getattr(mod, 'LAST', {})}; "
              f"kernel launches {_launches()}", flush=True)
        if name == "collect" and not _launches()["stage_windows"]:
            raise AssertionError("profile.collect never launched K6")


def phase13_bench():
    """The bench at its defaults with SH_BENCH_FULL=1 -> its kernel
    launches."""
    from sh_assembly_tpu_torch import bench

    print("== phase 13: the bench (sh_assembly_tpu_torch.bench, "
          "SH_BENCH_FULL=1)", flush=True)
    out = io.StringIO()
    env = {k: os.environ.get(k) for k in ("SH_BENCH_FULL",
                                          "SH_BENCH_DEADLINE")}
    os.environ["SH_BENCH_FULL"] = "1"
    os.environ.pop("SH_BENCH_DEADLINE", None)
    _reset_launches()
    try:
        with contextlib.redirect_stdout(out):
            rc, logtxt, wall = _run_main(bench.main, [])
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    launches = _launches()
    lines = out.getvalue().strip().splitlines()
    for line in lines:
        print(f"  {line}")
    for line in logtxt.splitlines():
        if line.startswith("# "):
            print(f"  {line}")
    windows = [line.split("(", 1)[1].rstrip(")") for line in
               logtxt.splitlines() if line.startswith("# primary window")]
    print(f"  bench wall {wall:.1f} s; kernel launches {launches}; loaded "
          f"counting windows: {'; '.join(windows)}", flush=True)
    if rc != 0:
        raise AssertionError(f"the bench exited {rc}")
    if not launches["stage_windows"]:
        raise AssertionError("the bench never launched K6 (collect staging)")
    primary = json.loads(lines[-1]) if lines else {}
    if primary.get("metric") != bench.PRIMARY:
        raise AssertionError("the bench's last line is not its primary JSON")
    if primary["merges"] < 2:
        raise AssertionError(f"{primary['merges']} merges in the timed "
                             f"window")
    e2e = json.loads(lines[-2]) if len(lines) > 1 else {}
    if e2e.get("metric") != bench.E2E or e2e.get("warm") is not True:
        raise AssertionError(f"no warm end-to-end line: {e2e}")
    if bench.LAST.get("identity") != "OK":
        raise AssertionError(f"K1 identity: {bench.LAST.get('identity')}")
    if bench.LAST["skipped"] or "skipped: bench deadline" in logtxt:
        raise AssertionError(f"skipped for the deadline: "
                             f"{bench.LAST['skipped']}")
    return launches


def main() -> int:
    import torch

    smi = phase0_device()
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
        mesh = phase10_mesh()
        mp = phase11_mesh()
        phase12_profiles()
        bench = phase13_bench()
        err5, timing5b = phase14_k5(dev)
        err6, timing6 = phase15_k6(dev)
        timing16 = phase16_k7_k8(dev)
        timing["contract"] = phase17_k9(dev)
        timing["members"] = phase18_k10(dev, launches["members"])
        t19 = phase19_k11_links(dev, {n: launches[n] for n in (
            "path_stats", "links")})
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    loaded = [m for m in sys.modules
              if m == "sh_assembly_tpu" or m.startswith("sh_assembly_tpu.")]
    if loaded:
        raise AssertionError(f"JAX package modules loaded: {loaded}")
    timing.update(timing5)
    # K5: profile.hot's shape, phase 7's beside it
    hot, gen = timing5b["hot"], timing5b["genome"]
    timing["hash_append"] = {
        **{k: hot[k] for k in ("ms", "wrapper_ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms")},
        **{f"genome_{k}": gen[k] for k in ("ms", "wrapper_ms", "plain_ms",
                                           "bound_ms")}}
    # K6: phase 7's stack, the bench's stage-2 stack beside it
    gen, st2 = timing6["genome"], timing6["stage2"]
    timing["stage_windows"] = {
        **{k: gen[k] for k in ("ms", "wrapper_ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms")},
        **{f"stage2_{k}": st2[k] for k in ("ms", "wrapper_ms", "plain_ms",
                                           "bound_ms")}}
    # K7 and K8: profile.stage2's graph shape, the closure's round 1 beside
    # it; K7 also at a later closure round (an append and a probe), its
    # build and probe apart, and the graph's probe of phase 7's store
    for name in ("node_join", "node_probes"):
        g, c = timing16["graph"][name], timing16["closure"][name]
        timing[name] = {
            **{k: g[k] for k in ("ms", "wrapper_ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms")},
            **{f"closure_{k}": c[k] for k in ("ms", "wrapper_ms", "plain_ms",
                                              "bound_ms")}}
    j7 = {w: timing16[w]["node_join"] for w in ("graph", "closure")}
    later = j7["closure"]["later"]
    timing["node_join"].update(
        **{f"{w}_{k}": j7[w][k] for w in j7 for k in ("build_ms",
                                                       "probe_ms")},
        main_graph_probe_ms=j7["graph"]["main_graph_probe_ms"],
        **{f"later_{k}": later[k] for k in ("ms", "append_ms", "probe_ms",
                                            "plain_ms", "bound_ms")})
    # K11 at phase 17's extent, the yeast cell's beside it; the link join
    # (through K7) at both, under the node join's entry
    k11, ln = t19["k11"], t19["links"]
    timing["path_stats"] = {
        **{k: k11["cell"][k] for k in ("ms", "wrapper_ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms")},
        **{f"yeast_{k}": k11["yeast"][k] for k in ("ms", "wrapper_ms",
                                                   "plain_ms", "bound_ms")}}
    timing["node_join"].update(
        **{f"links_{w}_{k}": ln[w][k] for w in ("cell", "yeast")
           for k in ("ms", "wrapper_ms", "plain_ms", "bound_ms")})
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
             prof),
            ("hash_append", "hash_append",
             "sh_assembly_tpu/models/counter.py:102 append_scan_packed (an "
             "XLA-fused lax.scan, not a pl.pallas_call)", err5, pipeline),
            ("stage_windows", "stage_windows",
             "sh_assembly_tpu/models/contiger.py:79 _stage_super (a jax.jit "
             "program, not a pl.pallas_call)", err6, pipeline),
            ("node_join", "node_join",
             "sh_assembly_tpu/ops/kmerpack.py:164 join2 (a sort-join inside "
             "the jax.jit programs sh_assembly_tpu/models/contiger.py:506 "
             "and :644, not a pl.pallas_call)", 0, pipeline),
            ("node_probes", "node_probes",
             "sh_assembly_tpu/models/contiger.py:421-505 _node_hashes, "
             "_succ_probes, _sibling_probes (inside the jax.jit programs "
             ":506 and :644, not a pl.pallas_call)", 0, pipeline),
            ("contract", "contract",
             "sh_assembly_tpu/models/contiger.py:766 contract_paths, :1102 "
             "_path_summary_np and sh_assembly_tpu/ops/kmerpack.py:86 "
             "revcomp_packed (run on the host there: cpp/contract.cpp and "
             "numpy; not a pl.pallas_call)", 0, pipeline),
            ("members", "members",
             "sh_assembly_tpu/models/contiger.py:1123 _finalize_host, its "
             "members step (:1131-1167: mask, np.lexsort, gathers; numpy on "
             "the host there, not a pl.pallas_call)", 0, pipeline),
            ("path_stats", "path_stats",
             "sh_assembly_tpu/models/contiger.py:1123 _finalize_host, its "
             "medians, sums and seed flags (:1177-1197: np.lexsort, "
             "np.add.reduceat; numpy on the host there, not a "
             "pl.pallas_call)", 0, pipeline)]
    print(smi)  # the card and its power limit again, beside the numbers
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"sh_assembly_tpu_torch/csrc/{name}.cu",
        "replaces": where, "launches": launches[name],
        "launches_in": path, "mesh_launches": mesh.get(name, 0),
        "mp_launches": mp.get(name, 0), "bench_launches": bench.get(name, 0),
        "max_abs_err": e, **timing[t]}
        for name, t, where, e, path in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main_nccl(world: int) -> int:
    """``--nccl-processes N``: phase 11a alone at N processes x 1 shard
    over NCCL, one card each (needs N cards)."""
    import torch

    phase0_device()
    sys.path.insert(0, REPO)
    if torch.cuda.device_count() < world:
        raise SystemExit(f"chip_smoke: --nccl-processes {world} needs "
                         f"{world} cards, {torch.cuda.device_count()} seen")
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        phase1_build()
        print(f"== phase 11a over NCCL: {world} processes x 1 shard, a card "
              f"each", flush=True)
        launches = phase11a_count(world, 1, "nccl")
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"ok": True, "mp_launches": launches, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.modules["jax"] = None  # the port runs without JAX: make sure of it
    if sys.argv[1:2] == ["--nccl-processes"]:
        sys.exit(main_nccl(int(sys.argv[2])))
    sys.exit(main())
