"""The traced run's reading of a ``torch.profiler`` Chrome trace.

Device activity is every kernel, copy and fill on the card.  The window is
the span from the first job's start to the last job's end (the harness
marks each job with a ``shbench:job`` range).  An idle gap is a stretch
of the window with nothing on the device; it is labelled with the
innermost program phase (a ``record_function`` range of the program)
around its middle.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
JOB = "shbench:job"


@dataclass
class Summary:
    window_s: float
    busy_s: float
    op_s: dict = field(default_factory=dict)  # device op name -> seconds
    gaps: list = field(default_factory=list)  # (label, seconds), longest first

    @property
    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def op_seconds(self, substring: str) -> float:
        return sum(s for n, s in self.op_s.items() if substring in n)


def _merge(iv: list) -> list:
    iv.sort()
    out = []
    for a, b in iv:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events: list, top: int = 10) -> Summary:
    """A summary of Chrome-trace events (``traceEvents``)."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    jobs = [e for e in xs if e.get("name") == JOB]
    if not jobs:
        raise ValueError("the trace holds no job range")
    w0 = min(e["ts"] for e in jobs)
    w1 = max(e["ts"] + e["dur"] for e in jobs)
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    op_s: dict = {}
    iv = []
    for e in dev:
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if b <= a:
            continue
        iv.append([a, b])
        op_s[e["name"]] = op_s.get(e["name"], 0.0) + (b - a) * 1e-6
    busy = _merge(iv)
    busy_us = sum(b - a for a, b in busy)
    phases = [e for e in xs if e.get("cat") == "user_annotation"
              and e.get("name") != JOB]
    gaps = []
    t = w0
    for a, b in busy + [[w1, w1]]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    labelled = []
    for a, b in gaps[:top]:
        mid = (a + b) / 2
        around = [e for e in phases if e["ts"] <= mid <= e["ts"] + e["dur"]]
        label = min(around, key=lambda e: e["dur"])["name"] if around \
            else "outside the program's phases"
        labelled.append((label, (b - a) * 1e-6))
    return Summary(window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6,
                   op_s=op_s, gaps=labelled)


def read(path: str, top: int = 10) -> Summary:
    with open(path) as f:
        return summarize(json.load(f)["traceEvents"], top)


def breakdown(s: Summary, top: int = 10) -> dict:
    ops = sorted(s.op_s.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in s.gaps[:top]]}
