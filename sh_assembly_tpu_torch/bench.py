"""Benchmarks of the port on one GPU: k-mer counting throughput at k = 47
under a realistic store load, plus the checks and rates beside it.

    python -m sh_assembly_tpu_torch.bench [--device cuda]

Counterpart of ``bench.py`` with its contract: JSON lines on stdout, the
primary metric LAST, everything else on stderr as ``# `` lines.  Sections,
in bench.py's order (each a function of its own):

  1. loaded counting, the primary metric (``loaded_counting``): k = 47,
     C = 2^28 slots (key_bits 36), a buffer of BC = 2^27; the store is
     filled on the device to a load near 0.5 (``fill``); then stacks of
     S = 8 batches of 8192 reads of 160 bp, staged on the device in the
     2-bit transport format, are hashed and appended
     (``counter.append_scan_packed``, one launch of kernel K5 a stack)
     with a buffer sort and K1 fold
     (``spectrum.merge``) before every group of S batches that would not
     fit; at least two merges fall in each of two timed windows, and the
     faster window is reported, with the device time of its merges
  2. the merge roofline at the same geometry (``roofline``)
  3. K1 against its plain twin, bitwise, after a merge and a sweep
     (``k1_identity``); a mismatch raises
  4. stage 2 (``stage2``): node collection, graph probes and contraction
     on a 2 Mbp genome at 30x, and the device-side staging and probe rates,
     with the launches of kernels K8 (node probes) and K7 (node join)
  5. the mesh's routed/plain ratio (``mesh_ratio``: ``profile.mesh.run`` at
     n = 8 on the device)
  6. end to end, reads -> contigs (``end_to_end``): ``cli.pipeline.main``
     twice in this process on a 1 Mbp genome at 30x, the second run
     reported with ``warm``; its JSON line prints before the primary one
  7. under ``SH_BENCH_FULL``: feed-included counting from a FASTQ on disk
     (``feed_included``)

``SH_BENCH_DEADLINE`` (default 1200 s from the start) skips an optional
section (2-7) whose reserve no longer fits, with ``# <section> skipped:
bench deadline``; the two JSON lines still print.  Any other error
propagates and the bench exits non-zero: nothing falls back to the CPU or
to a plain version.  ``SH_BENCH_BC_LOG2`` sets the default of
``--log2-buf``.  The geometry flags cut every section to a CPU size (whose
times mean nothing): the identity runs at 1/16 of ``--log2-capacity``'s
slots, the mesh ratio at 1/64 of them a shard with ``--rows`` / 8 reads a
shard, and stage 2 and feed-included size their stores from their data,
which gives bench.py's geometries at the defaults.

Baselines: the reference's own hot loop and traversal, built from its
sources in the directory ``SH_BENCH_REFERENCE`` names (with
``tests/ref_harness/``) and scaled to 16 threads, as bench.py measures
them; without that directory the counting baseline is the 20 M k-mers/s
literature anchor and the end-to-end ``vs_baseline`` is 0.0, and each JSON
line names its baseline's source in ``baseline_source``.

Not carried from bench.py: a K1 mismatch exits non-zero (bench.py's
identity check catches its own error and logs "skipped"); the
feed-included section writes its own FASTQ (bench.py's finds none without
the reference); rates are held against the H100's 3.35 TB/s, not a TPU's;
the mesh ratio runs on the device, not on a virtual CPU mesh; the
roofline's merge fits the store (bench.py's overflows it).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from . import config as cfgmod
from .cli import pipeline as pipe
from .cli.cqf_denoise import resolve_device
from .io import fastq
from .models import contiger, counter
from .ops import _build, contract_cuda, kmerpack as kp, merge_cuda, \
    node_join_cuda, nthash, packio, probe_cuda, spectrum as sp
from .profile import mesh
from .utils.profiling import median_ms

LITERATURE_ANCHOR = 20e6  # fallback: 16-thread CQF counting, CQF/squeakr lit
HBM_PEAK_GBPS = 3350.0  # one H100 SXM's published HBM3 rate
REF = os.environ.get("SH_BENCH_REFERENCE", "")  # the reference's sources
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

K, L = 47, 160
GENOME_LEN = 8_000_000
GENOME_SEED = 2038074761  # bench.py's: the genome and the staged reads
STAGE2_SEED, E2E_SEED, FEED_SEED = 2, 3, 1
PRIMARY = "kmers_counted_per_sec_per_gpu_k47_loaded"
E2E = "end_to_end_reads_to_contigs_1mbp30x_gpu"

# What the last main() in this process measured, by section, for callers
# (chip_smoke.py phase 13); "skipped" lists the sections the deadline cut.
LAST: dict = {}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# Baselines (bench.py's helpers)


def _build_ref(src_name: str, exe_name: str) -> str | None:
    """Compile a tests/ref_harness tool against the reference's sources."""
    src = os.path.join(HERE, "tests", "ref_harness", src_name)
    if not (REF and os.path.isdir(REF) and os.path.isfile(src)):
        return None
    exe = os.path.join(tempfile.gettempdir(), exe_name)
    r = subprocess.run(
        ["g++", "-Ofast", "-m64", "-std=c++11", f"-I{REF}/cqf",
         f"-I{REF}/base", "-x", "c++", f"{REF}/cqf/gqf.c", "-x", "c++",
         src, "-o", exe, "-lm", "-lpthread"], capture_output=True)
    return exe if r.returncode == 0 else None


def _write_fastq(path: str, rows: np.ndarray) -> None:
    n_reads, rl = rows.shape
    with open(path, "wb") as f:
        quals = b"I" * rl
        for i in range(n_reads):
            f.write(b"@r%d\n" % i)
            f.write(rows[i].tobytes())
            f.write(b"\n+\n%s\n" % quals)


def _reads(rng, genome: np.ndarray, n_reads: int, read_len: int):
    """ASCII rows of n_reads reads at random starts of a 0-3 genome."""
    starts = rng.integers(0, len(genome) - read_len, size=n_reads)
    return np.frombuffer(b"ACGT", np.uint8)[
        genome[starts[:, None] + np.arange(read_len)]]


def measure_cpu_baseline() -> tuple[float, str]:
    """16 x single-thread rate of the reference's compiled hot loop."""
    exe = _build_ref("ref_count.cpp", "bench_ref_count")
    if exe is None:
        return LITERATURE_ANCHOR, "literature (harness build failed)"

    k, read_len, n_reads = 47, 100, 150_000
    rng = np.random.default_rng(1)
    genome = rng.integers(0, 4, size=2_000_000).astype(np.uint8)
    fq = os.path.join(tempfile.gettempdir(), "bench_ref.fastq")
    _write_fastq(fq, _reads(rng, genome, n_reads, read_len))
    kmers = n_reads * (read_len - k + 1)
    qb = 24  # ~8.1M distinct kmers -> comfortably inside 2^24 slots
    with open(fq, "rb") as f:
        t0 = time.time()
        subprocess.run([exe, str(qb), str(qb + 8), str(k), "/dev/null"],
                       stdin=f, check=True, capture_output=True)
        dt = time.time() - t0
    single = kmers / dt
    rate = 16 * single
    log(f"# cpu baseline: ref hot loop {single/1e6:.1f}M kmers/s/thread "
        f"x16 = {rate/1e6:.1f}M/s ({kmers} kmers in {dt:.2f}s)")
    return rate, f"measured 16x single-thread ({single/1e6:.1f}M/s/thread)"


def measure_ref_e2e_baseline(fq_path: str, k: int, n_kmers: int
                             ) -> tuple[float, str]:
    """Reference end-to-end wall clock on the SAME FASTQ: ref_count (its
    hot loop) + ref_contiger (its traversal), single-thread / 16, the same
    generous perfect-scaling convention as the counting baseline."""
    cexe = _build_ref("ref_count.cpp", "bench_ref_count")
    gexe = _build_ref("ref_contiger.cpp", "bench_ref_contiger")
    if cexe is None or gexe is None:
        return 0.0, "unmeasured (harness build failed)"
    d = tempfile.gettempdir()
    ser = os.path.join(d, "bench_e2e_ref.ser")
    ofa = os.path.join(d, "bench_e2e_ref.fa")
    qb = 22  # ~1M distinct kmers at 1 Mbp; slack for xnslots
    t0 = time.time()
    with open(fq_path, "rb") as f:
        subprocess.run([cexe, str(qb), str(qb + 8), str(k), ser],
                       stdin=f, check=True, capture_output=True)
    with open(fq_path, "rb") as f:
        subprocess.run([gexe, ser, str(k), "1", "2", "1000000", ofa],
                       stdin=f, check=True, capture_output=True)
    dt = time.time() - t0
    scaled = dt / 16.0
    log(f"# ref e2e baseline: count+contiger single-thread {dt:.1f}s "
        f"/16 = {scaled:.1f}s ({n_kmers/dt/1e6:.1f}M kmers/s "
        f"single-thread)")
    return scaled, f"measured single-thread/16 ({dt:.1f}s x1)"


# ---------------------------------------------------------------------------
# 1. Loaded counting


def make_genome() -> tuple[np.random.Generator, np.ndarray]:
    """The 8 Mbp genome of codes 0-3 and the generator that goes on to draw
    the staged reads' starts."""
    rng = np.random.default_rng(GENOME_SEED)
    return rng, rng.integers(0, 4, size=GENOME_LEN).astype(np.uint8)


def make_stacks(rng, genome: np.ndarray, n_stacks: int, S: int, B: int,
                device) -> list[tuple[torch.Tensor, ...]]:
    """n_stacks packed [S, B, L] stacks of reads at random starts, staged on
    the device: (packed [S, B, L/4], nmask [S, B, L/8], lengths [S, B])."""
    out = []
    lengths = torch.full((S, B), L, dtype=torch.int32, device=device)
    for _ in range(n_stacks):
        starts = rng.integers(0, len(genome) - L, size=(S, B))
        pk, nm = packio.pack_np(genome[starts[..., None] + np.arange(L)])
        out.append((torch.from_numpy(pk).to(device),
                    torch.from_numpy(nm).to(device), lengths))
    return out


def rand_keys(device, seed: int, n: int, key_bits: int) -> torch.Tensor:
    """n random keys of key_bits bits from a device generator."""
    g = torch.Generator(device=device).manual_seed(seed)
    return nthash.mask_keys(torch.randint(0, 1 << 62, (n,), generator=g,
                                          device=device), key_bits)


def fill_pieces(capacity: int, buf_capacity: int) -> tuple[int, int]:
    """(keys a piece, pieces) of the fill: C random keys in pieces the
    buffer holds, at most C/2 a piece (2 x 2^27 at the defaults)."""
    n = min(buf_capacity, capacity // 2)
    return n, capacity // n


def fill(spec: sp.Spectrum, key_bits: int) -> sp.Spectrum:
    """Fill the store to a realistic load on the device: C random keys
    (piece i drawn from seed i), a merge after every piece; then the first
    half of the pieces again, the last merge a sweep, so that the keys
    drawn twice stay and the rest go (load ~0.5, the flagship's at its
    deNoise trigger)."""
    device = spec.store.device
    n, pieces = fill_pieces(spec.capacity, spec.buf_capacity)
    for i in range(pieces):
        spec = sp.merge(sp.insert(spec, rand_keys(device, i, n, key_bits)),
                        key_bits)
        sp.check_overflow(spec)
    for i in range(pieces // 2):
        spec = sp.merge(sp.insert(spec, rand_keys(device, i, n, key_bits)),
                        key_bits, drop_singletons=i == pieces // 2 - 1)
    return spec


def count_window(spec: sp.Spectrum, stacks, key_bits: int):
    """Hash and append every stack, with a merge before each stack that
    would not fit in the buffer -> (spec, merges, seconds of device time
    in the merges).  Synchronises before it returns."""
    device = spec.store.device
    cuda = device.type == "cuda"
    spans = []
    for pk, nm, ln in stacks:
        if spec.n_buf + pk.shape[0] * ln.shape[1] * (L - K + 1) > \
                spec.buf_capacity:
            if cuda:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
            else:
                t0 = time.perf_counter()
            spec = sp.merge(spec, key_bits)
            sp.check_overflow(spec)
            if cuda:
                b.record()
                spans.append((a, b))
            else:
                spans.append(time.perf_counter() - t0)
        spec = counter.append_scan_packed(spec, pk, nm, ln, K, key_bits, L)
    _sync(device)
    merge_s = sum(a.elapsed_time(b) / 1e3 for a, b in spans) if cuda \
        else sum(spans)
    return spec, len(spans), merge_s


def loaded_counting(device, log2_capacity: int, log2_buf: int, rows: int,
                    stacks: int, baseline: float, baseline_src: str):
    """The primary metric -> (its JSON dict, the loaded spectrum)."""
    key_bits = log2_capacity + 8
    C, BC = 1 << log2_capacity, 1 << log2_buf
    keys_per_super = stacks * rows * (L - K + 1)
    if keys_per_super > BC:
        raise ValueError(f"a stack of {keys_per_super} windows does not fit "
                         f"the {BC}-slot buffer; lower --stacks or --rows")
    n_supers = int(2.2 * BC / keys_per_super) + 1  # >= 2 merges a window
    t_all = time.time()
    rng, genome = make_genome()
    supers = make_stacks(rng, genome, n_supers, stacks, rows, device)
    log(f"# staged {n_supers} stacks of {stacks} x {rows} reads on {device} "
        f"({time.time() - t_all:.1f}s)")

    t0 = time.time()
    spec = fill(sp.make(C, BC, device), key_bits)
    _sync(device)
    log(f"# fill: {spec.ndistinct/1e6:.1f}M distinct at load "
        f"{spec.ndistinct/C:.2f} ({time.time() - t0:.1f}s)")

    spec, _, _ = count_window(spec, supers[:1], key_bits)  # first launches
    spec = sp.merge(spec, key_bits)
    _sync(device)
    kmers = n_supers * keys_per_super
    best = None
    for attempt in range(2):  # two windows; keep the faster
        t0 = time.time()
        spec, merges, merge_s = count_window(spec, supers, key_bits)
        dt = time.time() - t0
        log(f"# primary window {attempt + 1}: {kmers/dt/1e6:.1f}M kmers/s "
            f"({kmers} in {dt:.3f}s, {merges} merges taking {merge_s:.3f}s "
            f"of device time)")
        if best is None or dt < best[0]:
            best = (dt, merges, merge_s)
    dt, merges, merge_s = best
    rate = kmers / dt
    log(f"# primary(qb={log2_capacity}, BC=2^{log2_buf}, "
        f"{spec.ndistinct/1e6:.1f}M distinct at the last merge): "
        f"{rate/1e6:.1f}M kmers/s ({kmers} in {dt:.3f}s, {merges} merges, "
        f"{merge_s:.3f}s of it in sp.merge)")
    if merges < 2:
        raise RuntimeError(f"{merges} merges in the timed window; the rate "
                           f"is not steady state")
    log(f"# baseline source: {baseline_src}")
    del supers
    return {
        "metric": PRIMARY,
        "value": round(rate),
        "unit": "kmers/s",
        "vs_baseline": round(rate / baseline, 3),
        "baseline_source": baseline_src,
        "merges": merges,
        "merge_s": round(merge_s, 4),
    }, spec


# ---------------------------------------------------------------------------
# 2. Merge roofline


def roofline(spec: sp.Spectrum, key_bits: int) -> dict:
    """The buffer sort and sort + K1 (``spectrum.merge``, into the spare as
    the store folds) on a full buffer at spec's geometry.  The buffer holds
    the fill's first piece again: random keys the store holds already, so
    that the merge does not overflow the store (bench.py's fresh random
    keys would: 142 M live + 2^27 > 2^28 at the defaults)."""
    device = spec.store.device
    C, BC = spec.capacity, spec.buf_capacity
    n, _ = fill_pieces(C, BC)
    keys = rand_keys(device, 0, n, key_bits)
    specr = sp.insert(dataclasses.replace(spec, n_buf=0),
                      keys.repeat(-(-BC // n))[:BC])
    del keys
    buf = specr.buf[:BC]
    sp.sort_pack_buf(buf, key_bits)
    sort_ms = median_ms(lambda: sp.sort_pack_buf(buf, key_bits), 3, device)
    warm = sp.merge(specr, key_bits)
    sp.check_overflow(warm)
    # every call writes the same result into the same spare: its dirty
    # extent is now the larger of the two
    specr = dataclasses.replace(specr, spare_dirty=max(specr.spare_dirty,
                                                       warm.n_main))
    del warm
    merge_ms = median_ms(lambda: sp.merge(specr, key_bits), 3, device)
    gb = 16 * (C + BC) / 1e9
    rate = gb / (merge_ms / 1e3)
    log(f"# roofline(C=2^{C.bit_length() - 1},BC=2^{BC.bit_length() - 1}): "
        f"buf sort {sort_ms:.3f}ms, sort+merge {merge_ms:.3f}ms = "
        f"{rate:.0f} GB/s achieved vs {HBM_PEAK_GBPS:.0f} GB/s HBM peak "
        f"({100 * rate / HBM_PEAK_GBPS:.1f}%), counting 16 B a slot of store "
        f"and buffer (8 read, 8 written: {gb:.2f} GB); PERF.md's K1 bound "
        f"counts only the live words")
    return dict(sort_ms=sort_ms, merge_ms=merge_ms, gb=gb, gb_per_s=rate)


# ---------------------------------------------------------------------------
# 3. K1 identity


def k1_kernel(device):
    """The K1 launch to hold against the plain twin: None off CUDA."""
    return merge_cuda.merge_dedup_cuda if torch.device(device).type == \
        "cuda" else None


def k1_identity(device, kernel, log2_capacity: int = 24) -> str:
    """A merge, half the keys again, then ``kernel`` and the plain twin on
    the same merge + sweep, compared over the whole capacity; raises on a
    mismatch.  Returns "OK", or "no kernel" when there is none to compare."""
    if kernel is None:
        log(f"# bit-identity K1-vs-plain: no kernel on {device}; nothing "
            f"compared")
        return "no kernel"
    kb = log2_capacity + 8
    C, BC = 1 << log2_capacity, 1 << (log2_capacity - 2)
    keys = rand_keys(device, 11, BC, kb)
    spec = sp.merge(sp.insert(sp.make(C, BC, device), keys), kb)
    spec = sp.insert(spec, keys[:BC // 2])
    sb = sp.sort_pack_buf(spec.buf[:spec.n_buf], kb)
    got = kernel(spec.store, sb, spec.n_main, kb, True, C)
    want = merge_cuda.merge_dedup_plain(spec.store, sb, spec.n_main, kb,
                                        True, C)
    same = (int(got[1]) == int(want[1]) and int(got[2]) == int(want[2])
            and torch.equal(got[0], want[0]))
    log(f"# bit-identity K1-vs-plain (merge+sweep, qb={log2_capacity}): "
        f"{'OK' if same else 'MISMATCH'}")
    if not same:
        raise RuntimeError(
            f"K1/plain merge mismatch: n_live {int(got[1])} vs "
            f"{int(want[1])}, n_dropped {int(got[2])} vs {int(want[2])}, "
            f"{int((got[0] != want[0]).sum())} words differ")
    return "OK"


# ---------------------------------------------------------------------------
# 4. Stage 2


def _pow2_at_least(n: int) -> int:
    """The smallest power of two >= n, at least 1024."""
    return 1 << max(n - 1, 1023).bit_length()


def stage2(device, genome: np.ndarray, rows: int,
           genome_len: int = 2_000_000) -> dict:
    """Contiger rates at a loaded spectrum: collect_nodes over 30x of 160 bp
    reads of genome[:genome_len] in batches of `rows` reads, against their
    own spectrum in 16 slots a genome base (2^25 at 2 Mbp, as in bench.py),
    build_oriented_graph + the native contraction on the padded nodes (the
    second of two runs), and the device-side rates of ``_stage_super`` on
    8 x rows pre-staged rows and of ``build_oriented_graph`` on node k-mers
    taken from the genome."""
    device = torch.device(device)
    log2_capacity = (16 * genome_len - 1).bit_length()
    kb = log2_capacity + 8
    rng = np.random.default_rng(STAGE2_SEED)
    g2 = genome[:genome_len]
    Lr, cov = 160, 30
    W = Lr - K + 1
    n_batches = -(-(genome_len * cov // Lr) // rows)
    batches = []
    for _ in range(n_batches):
        starts = rng.integers(0, genome_len - Lr, size=rows)
        pk, nm = packio.pack_np(g2[starts[:, None] + np.arange(Lr)])
        batches.append(fastq.PackedBatch(
            packed=pk, nmask=nm, lengths=np.full(rows, Lr, np.int32),
            n_rows=rows))

    # the reads' own multiplicities (counts ~30)
    spec = sp.make(1 << log2_capacity, 1 << (log2_capacity - 1), device)
    for b in batches:
        if spec.n_buf + rows * W > spec.buf_capacity:
            spec = sp.merge(spec, kb)
        spec = counter.append_scan_packed(
            spec, torch.from_numpy(b.packed[None]).to(device),
            torch.from_numpy(b.nmask[None]).to(device),
            torch.from_numpy(b.lengths[None]).to(device), K, kb, Lr)
    spec = sp.drop_spare(sp.merge(spec, kb))
    sp.check_overflow(spec)
    windows = n_batches * rows * W

    def run_stage2():
        t0 = time.time()
        hi, lo, _ = contiger.collect_nodes(spec, iter(batches), K, kb, 2)
        _sync(device)
        t_collect = time.time() - t0
        n = hi.shape[0]
        Np = _pow2_at_least(n)
        hp = torch.full((Np,), contiger.SENT, dtype=torch.int64, device=device)
        lp = hp.clone()
        hp[:n], lp[:n] = hi, lo
        t0 = time.time()
        _, chain_next, _ = contiger.build_oriented_graph(spec, hp, lp, K, kb,
                                                         2)
        _sync(device)
        t_probe = time.time() - t0
        contract_cuda.contract(chain_next, hp, lp, K)  # where it lies
        _sync(device)
        return n, t_collect, t_probe, time.time() - t0

    run_stage2()  # the first launches
    before = (probe_cuda.LAUNCHES, node_join_cuda.LAUNCHES)
    n_nodes, t_collect, t_probe, t_graph = run_stage2()
    k8, k7 = probe_cuda.LAUNCHES - before[0], \
        node_join_cuda.LAUNCHES - before[1]
    log(f"# stage2(qb={log2_capacity}, {n_nodes/1e6:.3f}M nodes): collect "
        f"{windows/t_collect/1e6:.1f}M windows/s ({t_collect:.3f}s), "
        f"probe+contract {n_nodes/t_graph/1e6:.2f}M nodes/s ({t_graph:.3f}s: "
        f"probes {t_probe:.3f}s, contraction {t_graph - t_probe:.3f}s; "
        f"K8 node_probes {k8}, K7 node_join {k7} launches)"
        f"  [includes host feed]")

    # device-side rates on pre-staged inputs
    SB = 8 * rows
    starts = rng.integers(0, genome_len - Lr, size=SB)
    pk, nm = packio.pack_np(g2[starts[:, None] + np.arange(Lr)])
    dpk, dnm = torch.from_numpy(pk).to(device), torch.from_numpy(nm).to(device)
    dln = torch.full((SB,), Lr, dtype=torch.int32, device=device)
    dsc = torch.full((SB,), -1, dtype=torch.int32, device=device)
    pend = contiger._Pending.make(_pow2_at_least(SB * W), device)

    def stage_once():
        pend.n = 0
        contiger._stage_super(pend, dpk, dnm, dln, dsc, K, kb, Lr)

    stage_once()
    _sync(device)
    t0 = time.time()
    for _ in range(4):
        stage_once()
    _sync(device)
    t_stage = (time.time() - t0) / 4
    del pend

    Np2 = _pow2_at_least(n_nodes)
    starts = rng.integers(0, genome_len - K, size=Np2)
    dh, dl = (w[:, 0] for w in kp.pack_windows(torch.from_numpy(
        g2[starts[:, None] + np.arange(K)]).to(device), K))
    contiger.build_oriented_graph(spec, dh, dl, K, kb, 2)
    _sync(device)
    before = (probe_cuda.LAUNCHES, node_join_cuda.LAUNCHES)
    t0 = time.time()
    contiger.build_oriented_graph(spec, dh, dl, K, kb, 2)
    _sync(device)
    t_dev_probe = time.time() - t0
    dev_k8, dev_k7 = probe_cuda.LAUNCHES - before[0], \
        node_join_cuda.LAUNCHES - before[1]
    log(f"# stage2 device-side: stage {SB*W/t_stage/1e6:.0f}M windows/s, "
        f"probe {Np2/t_dev_probe/1e6:.2f}M nodes/s (pre-staged inputs, no "
        f"feed; K8 node_probes {dev_k8}, K7 node_join {dev_k7} launches)")
    return dict(nodes=n_nodes, windows=windows, collect_s=t_collect,
                collect_windows_per_s=windows / t_collect, graph_s=t_graph,
                graph_probe_s=t_probe, graph_nodes_per_s=n_nodes / t_graph,
                stage_windows_per_s=SB * W / t_stage, probe_nodes=Np2,
                probe_nodes_per_s=Np2 / t_dev_probe,
                node_probes_launches=k8 + dev_k8,
                node_join_launches=k7 + dev_k7)


# ---------------------------------------------------------------------------
# 5. Mesh ratio


def mesh_ratio(device, log2_capacity: int = 22,
               rows_per_shard: int = 1024) -> dict:
    """``profile.mesh.run`` at n = 8 on the device: the routed scan + merge
    against n plain single-shard calls."""
    res = mesh.run(device, 8, log2_capacity, rows_per_shard)
    log(f"# mesh(8 shards on {device}): routed {res['ms']:.3f}ms, one shard "
        f"plain {res['plain_ms']:.3f}ms, routed/plain ratio x{res['tax']:.2f} "
        f"(1.0 = routing costs nothing)")
    return res


# ---------------------------------------------------------------------------
# 6. End to end


def e2e_argv(workdir: str, genome_len: int, total_kmers: int,
             run: int) -> list[str]:
    """The pipeline's flags for run `run` (``--device`` not included)."""
    return ["-k", str(K), "-i", os.path.join(workdir, "ReadFiles.txt"),
            "-n", str(genome_len), "-N", str(total_kmers), "-e", "0.001",
            "--deNoise", "0", "-o", os.path.join(workdir, f"contigs{run}.fa"),
            "--unitigs", os.path.join(workdir, f"unitigs{run}.fa")]


def write_e2e_reads(workdir: str, genome_len: int, n_reads: int,
                    read_len: int = 100) -> str:
    """reads.fastq (n_reads error-free reads of a random genome) and its
    ReadFiles.txt in workdir -> the FASTQ's path."""
    rng = np.random.default_rng(E2E_SEED)
    genome = rng.integers(0, 4, size=genome_len).astype(np.uint8)
    fq_path = os.path.join(workdir, "reads.fastq")
    _write_fastq(fq_path, _reads(rng, genome, n_reads, read_len))
    with open(os.path.join(workdir, "ReadFiles.txt"), "w") as f:
        f.write("reads.fastq\n")
    return fq_path


def _cold_kind(device) -> str:
    """What the first run pays besides its own work."""
    if device.type != "cuda":
        return "the first run in this process (the CPU launches no kernel)"
    names = ("merge_dedup", "count_join", "merge128", "hash_append",
             "stage_windows")
    if all(n in _build._LIBS for n in names):
        return "the first launches only (every kernel already loaded)"
    if not any(os.path.exists(_build.lib_path(n)) for n in names):
        return "nvcc builds (csrc/build/ empty) and the first launches"
    return "library loads and the first launches"


def end_to_end(device, workdir: str, genome_len: int = 1_000_000,
               read_len: int = 100) -> dict:
    """cli.pipeline.main twice in this process on 30x of error-free reads
    of a random genome; the second (warm) run is reported.  Leaves
    contigs{0,1}.fa and unitigs{0,1}.fa in workdir."""
    n_reads = genome_len * 30 // read_len
    fq_path = write_e2e_reads(workdir, genome_len, n_reads, read_len)
    total_kmers = n_reads * (read_len - K + 1)
    ref_t, ref_src = measure_ref_e2e_baseline(fq_path, K, total_kmers)
    device = torch.device(device)
    cold = _cold_kind(device)
    times = []
    for run in range(2):
        t0 = time.time()
        rc = pipe.main(e2e_argv(workdir, genome_len, total_kmers, run)
                       + ["--device", str(device)])
        if rc != 0:
            raise RuntimeError(f"cli.pipeline exited {rc}")
        times.append(time.time() - t0)
        log(f"# e2e run {run + 1}: {times[-1]:.2f}s")
        if run == 0 and times[0] > 900.0:
            log("# e2e second run skipped (run 1 pathological); "
                "reporting run 1")
            break
    dte = times[-1]
    warm = len(times) > 1
    log(f"# end-to-end reads->contigs: {dte:.2f}s "
        f"({'warm' if warm else 'COLD - no rerun'}) for {n_reads} reads "
        f"({total_kmers/dte/1e6:.1f}M kmers/s incl. everything); cold run "
        f"{times[0]:.2f}s, which paid {cold}; ref baseline {ref_t:.1f}s "
        f"[{ref_src}]")
    return {
        "metric": E2E,
        "value": round(dte, 2),
        "unit": "s",
        "vs_baseline": round(ref_t / dte, 3) if ref_t else 0.0,
        "baseline_source": ref_src,
        "warm": warm,
        "cold_s": round(times[0], 2),
    }


# ---------------------------------------------------------------------------
# 7. Feed-included (SH_BENCH_FULL)


def feed_included(device, workdir: str, n_reads: int = 150_000,
                  rows: int = 8192) -> dict:
    """Disk FASTQ -> native 2-bit pack -> host-to-device copy -> counting:
    ``counter.build_spectrum_from_files`` on 4 copies of one FASTQ of
    n_reads reads of 100 bp (written here), in batches of `rows` reads,
    into a store of twice the FASTQ's k-mers (2^24 slots at 150,000 reads,
    as in bench.py), the second of two runs."""
    rng = np.random.default_rng(FEED_SEED)
    genome = rng.integers(0, 4, size=2_000_000).astype(np.uint8)
    fq = os.path.join(workdir, "feed.fastq")
    _write_fastq(fq, _reads(rng, genome, n_reads, 100))
    files = [fq] * 4
    kmers = 4 * n_reads * (100 - K + 1)
    log2_capacity = (kmers // 2 - 1).bit_length()
    sz = cfgmod.CounterSizing(
        k=K, qb=log2_capacity, hb=log2_capacity + 8, num_true_kmers=0,
        num_false_kmers=0, n_true_kmers=1, num_deNoise=0,
        ndistinct_for_deNoise=1 << 62, end_deNoise=False, fr=0.0)
    kw = dict(batch_cfg=cfgmod.BatchConfig(reads_per_batch=rows,
                                           max_read_len=104),
              capacity=1 << log2_capacity,
              buf_capacity=1 << (log2_capacity + 2), device=device)
    counter.build_spectrum_from_files(files, sz, **kw)  # first launches
    t0 = time.time()
    _, stats = counter.build_spectrum_from_files(files, sz, **kw)
    dt = time.time() - t0
    if stats.kmers != kmers:
        raise RuntimeError(f"feed-included counted {stats.kmers} k-mers of "
                           f"{kmers}")
    log(f"# feed-included(qb={log2_capacity}): {kmers/dt/1e6:.1f}M kmers/s "
        f"(disk + C++ decode/pack + H2D + device; {dt:.3f}s)")
    return dict(kmers=kmers, seconds=dt, kmers_per_s=kmers / dt)


# ---------------------------------------------------------------------------


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sh_assembly_tpu_torch.bench")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--log2-capacity", type=int, default=28,
                   help="loaded counting and roofline: store slots (log2)")
    p.add_argument("--log2-buf", type=int,
                   default=int(os.environ.get("SH_BENCH_BC_LOG2", "27")),
                   help="their buffer slots (log2; SH_BENCH_BC_LOG2)")
    p.add_argument("--rows", type=int, default=8192,
                   help="reads a batch (counting, stage 2, feed-included)")
    p.add_argument("--stacks", type=int, default=8,
                   help="batches a stack (loaded counting)")
    p.add_argument("--stage2-genome", type=int, default=2_000_000,
                   help="stage 2's genome length (30x of 160 bp reads)")
    p.add_argument("--e2e-genome", type=int, default=1_000_000,
                   help="end to end: genome length (30x of 100 bp reads)")
    p.add_argument("--feed-reads", type=int, default=150_000,
                   help="feed-included: reads of 100 bp in its FASTQ")
    return p


def main(argv: list[str] | None = None) -> int:
    args = make_parser().parse_args(argv)
    device = resolve_device(args.device)
    LAST.clear()
    LAST["skipped"] = []
    t_all = time.time()
    deadline = t_all + float(os.environ.get("SH_BENCH_DEADLINE", "1200"))

    def run(name: str, reserve: float, fn, *a, **kw):
        """fn(*a, **kw) unless fewer than `reserve` seconds are left."""
        if deadline - time.time() <= reserve:
            log(f"# {name} skipped: bench deadline")
            LAST["skipped"].append(name)
            return None
        LAST[name] = fn(*a, **kw)
        return LAST[name]

    baseline, baseline_src = measure_cpu_baseline()
    key_bits = args.log2_capacity + 8
    primary_json, spec = loaded_counting(
        device, args.log2_capacity, args.log2_buf, args.rows, args.stacks,
        baseline, baseline_src)
    LAST["primary"] = primary_json
    run("roofline", 60, roofline, spec, key_bits)
    del spec
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the identity and the mesh ratio at bench.py's smaller geometries
    # (2^24 and 8 x 2^22 slots, 1024 reads a shard at the defaults)
    run("identity", 90, k1_identity, device, k1_kernel(device),
        args.log2_capacity - 4)
    _, genome = make_genome()
    run("stage2", 300, stage2, device, genome, args.rows, args.stage2_genome)
    del genome
    run("mesh ratio", 240, mesh_ratio, device, args.log2_capacity - 6,
        max(args.rows // 8, 1))
    with tempfile.TemporaryDirectory(prefix="bench_e2e_") as d:
        e2e_json = run("end-to-end", 180, end_to_end, device, d,
                       args.e2e_genome)
        if os.environ.get("SH_BENCH_FULL"):
            run("feed-included", 60, feed_included, device, d,
                args.feed_reads, args.rows)

    log(f"# total bench time {time.time() - t_all:.0f}s")
    if e2e_json is not None:
        print(json.dumps(e2e_json), flush=True)
    # the PRIMARY metric prints last: a reader parses the last JSON line
    print(json.dumps(primary_json), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
