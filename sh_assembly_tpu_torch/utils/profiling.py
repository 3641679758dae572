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
``phase(name, sync=False)`` leaves CUDA alone: for a span of host work,
and for any span on a thread that must not wait on the card.

Spans nest: each records as its ``parent`` the innermost span open on the
same thread when it first opened, and ``report()`` prints children under
their parent with the parent's self time.  A child's name is its parent's,
a dot, and the step (``contiger:contract.walk``).
"""

from __future__ import annotations

import contextlib
import os
import statistics
import threading
import time
from dataclasses import dataclass, field

import torch

from .logging import log


@dataclass
class _PhaseStat:
    seconds: float = 0.0
    calls: int = 0
    parent: str | None = None  # innermost span open when it first opened
    thread: str = ""  # the thread that writes it


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
    """Accumulates wall-clock per named phase.  Each name is written by one
    thread; spans on several threads may be open at once, each thread with
    its own stack of open spans."""

    stats: dict[str, _PhaseStat] = field(default_factory=dict)
    t_start: float = field(default_factory=time.perf_counter)
    _open: threading.local = field(default_factory=threading.local,
                                   repr=False, compare=False)

    def _stack(self) -> list:
        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        return stack

    @contextlib.contextmanager
    def phase(self, name: str, sync: bool = True):
        stack = self._stack()
        st = self.stats.get(name)
        if st is None:
            st = self.stats[name] = _PhaseStat(
                parent=stack[-1] if stack else None,
                thread=threading.current_thread().name)
        stack.append(name)
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield
                if sync:
                    _sync()
        finally:
            stack.pop()
        st.seconds += time.perf_counter() - t0
        st.calls += 1

    def report(self, header: str = "phase breakdown") -> str:
        """Spans as trees, children indented under their parent with the
        parent's self time.  "Covered" counts the main thread's top-level
        spans only: a child's time lies inside its parent's, and another
        thread's spans run beside the main thread's."""
        total = time.perf_counter() - self.t_start
        kids: dict = {}
        for name, s in self.stats.items():
            kids.setdefault(s.parent, []).append(name)
        main = threading.main_thread().name
        tops = kids.get(None, [])
        covered = sum(self.stats[n].seconds for n in tops
                      if self.stats[n].thread == main)

        def tree(names, depth=0):
            for name in sorted(names, key=lambda n: -self.stats[n].seconds):
                yield depth, name
                yield from tree(kids.get(name, []), depth + 1)

        here = list(tree(n for n in tops if self.stats[n].thread == main))
        beside = list(tree(n for n in tops if self.stats[n].thread != main))
        width = max((2 * d + len(n) for d, n in here + beside), default=0)

        def row(depth, name):
            s = self.stats[name]
            pct = s.seconds / total * 100 if total else 0.0
            text = (f"  {'  ' * depth + name:<{width}}  {s.seconds:8.2f}s "
                    f"{pct:5.1f}% ({s.calls} calls")
            if name in kids:
                own = s.seconds - sum(self.stats[c].seconds
                                      for c in kids[name])
                text += f", self {own:.2f}s"
            return text + ")"

        lines = [f"{header} (total {total:.2f}s, "
                 f"{covered / total * 100 if total else 0:.0f}% covered):"]
        lines += [row(d, n) for d, n in here]
        if beside:
            lines.append("  on other threads, beside the above:")
            lines += [row(d, n) for d, n in beside]
        return "\n".join(lines)

    def log_report(self, header: str = "phase breakdown") -> None:
        for line in self.report(header).splitlines():
            log(line)


# Process-global timer: library code records into this by default so CLIs
# get a breakdown without threading a timer through every signature.
GLOBAL = PhaseTimer()


def phase(name: str, sync: bool = True):
    return GLOBAL.phase(name, sync)


def reset() -> None:
    GLOBAL.stats.clear()
    GLOBAL.t_start = time.perf_counter()


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
