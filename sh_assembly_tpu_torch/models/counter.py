"""K-mer spectrum builder — the CQF-deNoise stage, on a PyTorch device.

Counterpart of ``sh_assembly_tpu/models/counter.py``:

  host: read -> N-segment -> 2-bit pack (B, L) batches   (io/native, C++)
      -> stacks of ``super_batch`` batches, one pinned copy a stack array
  device, per stack: unpack -> windowed canonical ntHash -> key mod
      2^key_bits -> append raw keys to the log buffer, all S batches in one
      launch of kernel K5 (``append_scan_packed``, ``ops/hash_append_cuda``)
  when the buffer would overflow, or early when the buffered keys could
      reach the deNoise trigger: sort the buffer, fold it into the sorted
      store (kernel K1), and sweep singletons if the trigger fires
      (``merge_maybe_sweep``)
  end of stream: finalize merge, threshold sweep, optional endDeNoise sweep

The merge cadence is the JAX package's exactly, because which keys a sweep
removes depends on it: every batch appends a fixed block of BW slots, and
before each append the host checks ``need_merge_before``.  A stack goes to
the device in one append only where the rule fires nowhere inside it; a
stack it cuts, and the tail stack, go batch by batch with the check before
each, so the result does not depend on ``super_batch``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from dataclasses import dataclass
from typing import Iterable, Iterator

import numpy as np
import torch

from .. import config as cfg
from ..io import fastq
from ..ops import hash_append_cuda, packio, spectrum as sp
from ..utils import profiling
from ..utils.logging import log


@dataclass
class BuildStats:
    batches: int = 0
    merges: int = 0
    sweeps: int = 0  # deNoise rounds fired plus the end sweep
    kmers: int = 0
    distinct: int = 0
    seconds: float = 0.0
    rounds: int = 0  # deNoise rounds fired (mid-stream and on the last chunk)
    swept: int = 0  # keys those rounds dropped
    early_merges: int = 0  # merges the near-trigger rule fired
    reader_parts: int = 0  # parts the native reader decoded
    reader_workers: int = 0  # its workers that decoded at least one


def _prefetch(it: Iterator, depth: int = 8) -> Iterator:
    """Pull from `it` on a background thread so host read/decode overlaps
    device compute.

    If the consumer exits early (overflow raise, generator close), the
    worker is cancelled via a flag it checks between bounded q.put attempts
    and the source iterator is closed so generator finally-blocks run (the
    native reader handle would otherwise leak its C++ threads).

    Each pull from `it` is the span `count:reader next`, on the worker's
    thread: the reader's time to hand over one batch."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    DONE = object()
    cancelled = threading.Event()

    def worker():
        try:
            while True:
                with profiling.phase("count:reader next", sync=False):
                    x = next(it, DONE)
                if x is DONE:
                    break
                while not cancelled.is_set():
                    try:
                        q.put(x, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if cancelled.is_set():
                    return
            q.put(DONE)
        except BaseException as e:  # surface errors at the consumer
            if not cancelled.is_set():
                q.put(e)

    t = threading.Thread(target=worker, name="prefetch", daemon=True)
    t.start()
    try:
        while True:
            x = q.get()
            if x is DONE:
                return
            if isinstance(x, BaseException):
                raise x
            yield x
    finally:
        cancelled.set()
        close = getattr(it, "close", None)
        if close is not None:
            t.join(timeout=5.0)  # let the worker leave the iterator first
            close()


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor.  On CUDA the copy is asynchronous from
    a freshly pinned tensor: PyTorch's pinned-memory allocator does not hand
    that block out again until the copy has finished, so no later batch can
    overwrite memory a copy is still reading.  The numpy array itself is
    never written after this call (each stack comes in fresh arrays)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _append(spec: sp.Spectrum, lengths: torch.Tensor, k: int, key_bits: int,
            L: int, **bases) -> sp.Spectrum:
    """Hash every window of the rows of ``lengths`` (L bases each) and
    append the keys (K5 on CUDA, its plain twin on the CPU): n_buf advances
    by every window, nelts by the valid ones, as ``sp.insert`` advances
    them."""
    nelts = hash_append_cuda.hash_append(
        spec.buf, spec.n_buf, spec.nelts, lengths, k, key_bits, **bases)
    return dataclasses.replace(
        spec, n_buf=spec.n_buf + lengths.numel() * (L - k + 1), nelts=nelts)


def count_batch(spec: sp.Spectrum, codes: torch.Tensor, lengths: torch.Tensor,
                k: int, key_bits: int) -> sp.Spectrum:
    """Hash every window of one batch of base codes (u8[B, L]) and append
    the keys; the buffer is written in place."""
    return _append(spec, lengths, k, key_bits, codes.shape[-1], codes=codes)


def append_scan(spec: sp.Spectrum, codes: torch.Tensor, lengths: torch.Tensor,
                k: int, key_bits: int) -> sp.Spectrum:
    """Hash and append a stack of S batches of base codes (u8[S, B, L],
    lengths int32[S, B]) in one launch, as S ``count_batch`` calls would.
    No merge inside: the caller keeps the stack within the buffer's
    headroom (``build_spectrum``'s cadence rule)."""
    return _append(spec, lengths, k, key_bits, codes.shape[-1], codes=codes)


def append_scan_packed(spec: sp.Spectrum, packed: torch.Tensor,
                       nmask: torch.Tensor, lengths: torch.Tensor, k: int,
                       key_bits: int, max_read_len: int) -> sp.Spectrum:
    """``append_scan`` over a 2-bit packed stack (``ops/packio``): packed
    u8[S, B, L/4], nmask u8[S, B, L/8], lengths int32[S, B], L =
    max_read_len; the kernel unpacks on the device."""
    if packed.shape[-1] * 4 != max_read_len:
        raise ValueError(f"packed rows hold {packed.shape[-1] * 4} bases, "
                         f"max_read_len is {max_read_len}")
    return _append(spec, lengths, k, key_bits, max_read_len, packed=packed,
                   nmask=nmask)


def merge_maybe_sweep(spec: sp.Spectrum, rounds_left: int, threshold: int,
                      key_bits: int, stats: BuildStats | None = None,
                      merge_span: str | None = None,
                      sweep_span: str = "count:merge.deNoise",
                      ) -> tuple[sp.Spectrum, int]:
    """Buffer merge, then the deNoise sweep iff rounds remain and the
    post-merge distinct count crosses the threshold (the reference's
    needDeNoise).  Raises if the merge overflowed the store.  Returns
    (spec, rounds_left).

    The merge runs inside the span ``merge_span`` when one is named, the
    sweep inside ``sweep_span``; both are ``sync=False``: each fold ends
    with its own host read of the live count.  ``stats`` counts the round
    and the keys it dropped."""
    with (profiling.phase(merge_span, sync=False) if merge_span
          else contextlib.nullcontext()):
        spec = sp.merge(spec, key_bits)
        sp.check_overflow(spec)
    if rounds_left <= 0 or spec.ndistinct < threshold:
        return spec, rounds_left
    before = spec.ndistinct
    with profiling.phase(sweep_span, sync=False):
        spec = sp.sweep(spec, key_bits)
    if stats is not None:
        stats.rounds += 1
        stats.swept += before - spec.ndistinct
    return spec, rounds_left - 1


def build_spectrum(
    batches: Iterable[fastq.Batch],
    sizing: cfg.CounterSizing,
    capacity: int | None = None,
    buf_capacity: int | None = None,
    batch_cfg: cfg.BatchConfig | None = None,
    progress_every: int = 0,
    super_batch: int = 8,
    tight_denoise: bool = True,
    device="cuda",
) -> tuple[sp.Spectrum, BuildStats]:
    """Count canonical k-mers of a batch stream into a merged Spectrum.

    Host batches are stacked ``super_batch`` at a time; a stack goes to the
    device in one pinned copy a stack array and, where the cadence rule
    fires nowhere inside it, one append (``append_scan_packed``); the merge
    and sweep (``merge_maybe_sweep``) run between appends at the exact
    per-batch cadence, so the result does not depend on ``super_batch``.

    tight_denoise=False restores the pure buffer-boundary sweep cadence
    (used by cadence-characterization tests; the default is the tighter
    near-threshold trigger, see need_merge_before).
    """
    if super_batch < 1:
        raise ValueError(f"super_batch {super_batch} < 1")
    device = torch.device(device)
    batch_cfg = batch_cfg or cfg.BatchConfig()
    k, key_bits = sizing.k, sizing.qb + 8
    S, B, L = super_batch, batch_cfg.reads_per_batch, batch_cfg.max_read_len
    Lp = (L + 7) // 8 * 8  # packed transport needs L % 8 == 0
    # every batch appends exactly BW slots (padding included), so
    # spec.n_buf is a deterministic host count
    BW = B * (Lp - k + 1)
    if capacity is None:
        capacity = sizing.nslots  # same memory scaling rule as qf_init
    if buf_capacity is None:
        buf_capacity = 1 << max(4 * BW - 1, (1 << 20) - 1).bit_length()
        # a larger buffer amortizes the per-merge O(capacity) pass over the
        # store; grow toward C/2, capped at 2^27 slots (1 GiB)
        buf_capacity = max(buf_capacity, min(capacity // 2, 1 << 27))
    if buf_capacity < 2 * BW:
        raise ValueError(
            f"buf_capacity {buf_capacity} must be >= 2x windows/batch "
            f"({BW}) so one batch of keys always fits")

    spec = sp.make(capacity, buf_capacity, device)
    stats = BuildStats()
    rounds_left = int(sizing.num_deNoise)
    threshold = int(sizing.ndistinct_for_deNoise)
    t0 = time.time()

    def need_merge_before(n_buf: int) -> str | None:
        """The per-batch cadence rule (the JAX package's, verbatim) at a
        buffer fill of n_buf: "full", "early" or None, the rule that fires;
        ndistinct and rounds_left change only at merges."""
        if n_buf + BW > buf_capacity:
            return "full"
        # tighter deNoise cadence: when the buffered occurrences could push
        # ndistinct over the trigger, merge early so the sweep fires within
        # ~BC/4 of the crossing instead of up to one full buffer late.  The
        # n_buf >= BC/4 guard caps the extra merge cost at 4x cadence.
        if (tight_denoise and rounds_left > 0
                and n_buf >= buf_capacity // 4
                and spec.ndistinct + n_buf >= threshold):
            return "early"
        return None

    def do_merge(rule: str):
        nonlocal spec, rounds_left
        before = rounds_left
        early = rule == "early"
        spec, rounds_left = merge_maybe_sweep(
            spec, rounds_left, threshold, key_bits, stats,
            merge_span="count:merge.early" if early else None)
        stats.merges += 1
        stats.early_merges += early
        if rounds_left < before:
            log(f"deNoise sweep {sizing.num_deNoise - rounds_left}: "
                f"distinct={spec.ndistinct}")

    def new_stack():
        # FRESH arrays for every stack: a stack's copies to the device may
        # still be reading the last one
        return (np.zeros((S, B, Lp // 4), np.uint8),
                np.full((S, B, Lp // 8), 0xFF, np.uint8),
                np.zeros((S, B), np.int32))

    def flush_stack(stack, fill: int):
        nonlocal spec
        # does the cadence rule fire anywhere inside this stack?
        nb, split = spec.n_buf, False
        for _ in range(fill):
            if need_merge_before(nb):
                split = True
                break
            nb += BW
        with profiling.phase("count:device append"):
            pk, nm, ln = (_to_device(a[:fill], device) for a in stack)
            if not split and fill == S:
                # one launch for the whole stack
                spec = append_scan_packed(spec, pk, nm, ln, k, key_bits, Lp)
                return
        # a merge inside the stack (or its tail): batch by batch, with the
        # cadence rule before each
        for i in range(fill):
            rule = need_merge_before(spec.n_buf)
            if rule:
                with profiling.phase("count:merge"):
                    do_merge(rule)
            with profiling.phase("count:device append"):
                spec = append_scan_packed(spec, pk[i:i + 1], nm[i:i + 1],
                                          ln[i:i + 1], k, key_bits, Lp)

    pad_cols = Lp - L
    stack, fill = new_stack(), 0
    it = _prefetch(iter(batches))
    while True:
        with profiling.phase("count:host read/pack"):
            with profiling.phase("count:host read/pack.wait", sync=False):
                batch = next(it, None)
            if batch is None:
                break
            if isinstance(batch, fastq.PackedBatch):
                # already in transport format (native reader packed path)
                if batch.row_len != Lp:
                    raise ValueError(
                        f"packed row length {batch.row_len} != expected {Lp}")
                p, m = batch.packed, batch.nmask
            else:
                codes = batch.codes
                if pad_cols:
                    codes = np.pad(codes, ((0, 0), (0, pad_cols)),
                                   constant_values=5)
                p, m = packio.pack_np(codes)
            stack[0][fill], stack[1][fill], stack[2][fill] = \
                p, m, batch.lengths
        fill += 1
        stats.batches += 1
        if fill == S:
            flush_stack(stack, fill)
            stack, fill = new_stack(), 0
            if progress_every and stats.batches % progress_every < S:
                log(f"batch {stats.batches}: nelts={int(spec.nelts)} "
                    f"ndistinct(last merge)={spec.ndistinct}")
    if fill:
        flush_stack(stack, fill)

    with profiling.phase("count:finalize merge+sweeps"):
        # the reference's trigger also fires on the final chunk
        before = rounds_left
        spec, rounds_left = merge_maybe_sweep(
            spec, rounds_left, threshold, key_bits, stats,
            sweep_span="count:finalize merge+sweeps.deNoise")
        stats.merges += 1
        if rounds_left < before:
            log(f"deNoise sweep done; distinct={spec.ndistinct}")
        if sizing.end_deNoise:
            spec = sp.sweep(spec, key_bits)
            log(f"end deNoise sweep; distinct={spec.ndistinct}")

    stats.sweeps = stats.rounds + (1 if sizing.end_deNoise else 0)
    stats.kmers = int(spec.nelts)
    stats.distinct = spec.ndistinct
    stats.seconds = time.time() - t0
    # counting is over: whoever takes the store needs no second buffer
    return sp.drop_spare(spec), stats


def default_batch_cfg(sizing: cfg.CounterSizing,
                      max_read_len: int = 160) -> cfg.BatchConfig:
    """Batch geometry scaled to the filter size: keeps the log buffer (4x a
    batch's windows) comparable to the spectrum capacity."""
    wrow = max_read_len - sizing.k + 1
    rows = max(min(8192, sizing.nslots // (8 * wrow)), 128)
    rows = 1 << (rows.bit_length() - 1)  # round down to a power of two
    return cfg.BatchConfig(reads_per_batch=rows, max_read_len=max_read_len)


def build_spectrum_from_files(
    files: list[str],
    sizing: cfg.CounterSizing,
    fmode: str = "auto",
    batch_cfg: cfg.BatchConfig | None = None,
    n_threads: int = 4,
    **kw,
) -> tuple[sp.Spectrum, BuildStats]:
    from ..io import native

    batch_cfg = batch_cfg or default_batch_cfg(sizing)
    Lp = (batch_cfg.max_read_len + 7) // 8 * 8
    reader = native.ReaderStats()
    stream = native.packed_batches_from_files(
        files, sizing.k, fmode, batch_cfg.reads_per_batch, Lp,
        n_threads=n_threads, stats=reader,
    )
    spec, stats = build_spectrum(stream, sizing, batch_cfg=batch_cfg, **kw)
    stats.reader_parts, stats.reader_workers = reader.parts, reader.workers
    log(f"reader: {reader.parts} parts on {reader.workers} workers; the "
        f"hand-off waited {reader.wait_s:.3f}s for parts in order")
    return spec, stats
