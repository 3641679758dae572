"""Phase timing + device profiling hooks.

Same API as ``sh_assembly_tpu.utils.profiling``:

  * ``phase(name)`` — a context manager accumulating wall-clock and call
    counts per named phase; ``report()`` renders the breakdown.
  * device tracing — every ``phase`` is also a
    ``torch.profiler.record_function`` span, so phases show up by name in
    a ``torch.profiler`` trace.  Set ``SH_ASSEMBLY_TRACE_DIR=/some/dir`` to
    capture a Chrome trace of a CLI run (``maybe_trace`` wraps the CLI
    mains).

A phase synchronises CUDA when it ends (if CUDA is in use), so its time
covers the device work queued inside it rather than only the enqueue.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from dataclasses import dataclass, field

import torch

from .logging import log


@dataclass
class _PhaseStat:
    seconds: float = 0.0
    calls: int = 0


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def median_ms(fn, reps: int, device) -> float:
    """Median over ``reps`` calls of ``fn``'s time in milliseconds: CUDA
    events around each call on a CUDA device, the host clock on the CPU.
    The caller warms ``fn`` up first."""
    times = []
    if torch.device(device).type == "cuda":
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def queued_ms(fn, reps: int) -> float:
    """Device milliseconds a call of ``fn`` on the current CUDA device, the
    host's launch path hidden: a spin kernel holds the stream while reps
    calls queue up behind it, and CUDA events time them back to back."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # ~50 ms of spinning
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


@dataclass
class PhaseTimer:
    """Accumulates wall-clock per named phase.  Not thread-safe (the
    pipeline is single-threaded on the host)."""

    stats: dict[str, _PhaseStat] = field(default_factory=dict)
    t_start: float = field(default_factory=time.time)

    @contextlib.contextmanager
    def phase(self, name: str):
        st = self.stats.setdefault(name, _PhaseStat())
        t0 = time.time()
        with torch.profiler.record_function(name):
            yield
            _sync()
        st.seconds += time.time() - t0
        st.calls += 1

    def report(self, header: str = "phase breakdown") -> str:
        total = time.time() - self.t_start
        covered = sum(s.seconds for s in self.stats.values())
        lines = [f"{header} (total {total:.2f}s, "
                 f"{covered / total * 100 if total else 0:.0f}% covered):"]
        width = max((len(n) for n in self.stats), default=0)
        for name, s in sorted(self.stats.items(),
                              key=lambda kv: -kv[1].seconds):
            pct = s.seconds / total * 100 if total else 0.0
            lines.append(f"  {name:<{width}}  {s.seconds:8.2f}s {pct:5.1f}% "
                         f"({s.calls} calls)")
        return "\n".join(lines)

    def log_report(self, header: str = "phase breakdown") -> None:
        for line in self.report(header).splitlines():
            log(line)


# Process-global timer: library code records into this by default so CLIs
# get a breakdown without threading a timer through every signature.
GLOBAL = PhaseTimer()


def phase(name: str):
    return GLOBAL.phase(name)


def reset() -> None:
    GLOBAL.stats.clear()
    GLOBAL.t_start = time.time()


@contextlib.contextmanager
def maybe_trace():
    """Wrap a CLI main in a torch.profiler trace when
    SH_ASSEMBLY_TRACE_DIR is set; writes a Chrome trace there."""
    trace_dir = os.environ.get("SH_ASSEMBLY_TRACE_DIR")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    log(f"device trace -> {trace_dir}")
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
