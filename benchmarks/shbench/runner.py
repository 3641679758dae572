"""One run of one cell: set-up, warm-up, the measured window, the check,
the result line.

  1. generate the cell's genome and reads from the seed, write the FASTQ
     and read-file lists under a fresh directory in ``TMPDIR``;
  2. warm up with one job on the first 1/16 of the reads, under the cell's
     own flags (the same store sizes), so that every kernel library is
     built and loaded;
  3. run whole jobs back to back, starting a new one only while fewer than
     ``seconds`` have passed; the last job runs to its end and counts;
  4. with ``trace``, the window runs under ``torch.profiler``;
  5. after the window: the peak device memory, then the program's outputs
     to the host and its state freed, then the plain reference on the same
     reads and the comparison.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

from . import cellflags, generate, registry
from . import trace as trace_mod

FORBIDDEN = ("jax", "jaxlib", "flax", "sh_assembly_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the run must not load."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def run(workload: str, seed: int, seconds: float, traced: bool,
        device: str = "cuda", t_start: float | None = None,
        root: str = registry.ROOT, here: str = registry.HERE) -> dict:
    """The result of one run as a dict (the last line's object)."""
    import torch

    t_start = time.time() if t_start is None else t_start
    cell = registry.resolve(workload, root, here)
    config, traffic = cell["config"], cell["traffic"]
    work = tempfile.mkdtemp(prefix="shbench-")
    try:
        reads = generate.make_reads(seed, config, traffic)
        n = reads.shape[0]
        full = generate.write_job_files(work, "reads", reads)
        warm = generate.write_job_files(work, "warm", reads[:max(n // 16,
                                                                  1)])
        ctx = {"config": config, "traffic": traffic, "device": device,
               "workdir": work, "n_reads": n}
        entry = cell["entry"].Entry(ctx)
        entry.job(warm)
        if hasattr(entry, "reset"):
            entry.reset()
        cuda = torch.device(device).type == "cuda"
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        from sh_assembly_tpu_torch.utils import profiling

        jobs, phases = [], []
        prof = _profiler(torch, cuda) if traced else None
        setup_s = time.time() - t_start
        if prof is not None:
            prof.__enter__()
        t0 = time.perf_counter()
        while not jobs or time.perf_counter() - t0 < seconds:
            with torch.profiler.record_function(trace_mod.JOB):
                jobs.append(entry.job(full))
            phases.append({k: v.seconds
                           for k, v in profiling.GLOBAL.stats.items()})
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        summary = None
        if prof is not None:
            prof.__exit__(None, None, None)
            path = os.path.join(work, "trace.json")
            prof.export_chrome_trace(path)
            summary = trace_mod.read(path)
            os.remove(path)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        entry.collect(jobs)
        if cuda:
            torch.cuda.empty_cache()
        reads_dev = torch.from_numpy(reads).to(device)
        del reads
        nums, failed = entry.judge(reads_dev)
        del reads_dev
        limits = cell["entry"].LIMITS
        checks = {k: {"value": nums[k], "limit": limits[k]} for k in limits}
        correct = all(c["value"] <= c["limit"] for c in checks.values())
        ctx = {"jobs": jobs, "phases": phases, "window_s": window_s,
               "setup_s": setup_s, "peak_bytes": peak, "trace": summary,
               "kmers": n * cellflags.windows(config, traffic) * len(jobs),
               "config": config, "traffic": traffic}
        wanted = cell["per_layer"] if traced else cell["end_to_end"]
        metrics = {}
        for m in wanted:
            v = cell["readers"][m["name"]].read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev = {"platform": "gpu" if cuda else "cpu",
               "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
               "count": int(cell["cell"]["chips"]),
               "memory_peak_bytes": int(peak)}
        if summary is not None:
            dev["busy_s"] = summary.busy_s
            dev["window_s"] = summary.window_s
        out = {"correct": bool(correct), "attempted": len(jobs),
               "failed": int(failed), "metrics": metrics, "device": dev}
        if summary is not None:
            out["breakdown"] = trace_mod.breakdown(summary)
        out["checks"] = checks
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _profiler(torch, cuda: bool):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def main(args, t_start: float) -> int:
    import torch

    cell = registry.load_benchmark()
    chips = next((w["chips"] for w in cell["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        print(f"no workload named {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 3
    try:
        import sh_assembly_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program under test is not here: {e}", file=sys.stderr)
        return 4
    res = run(args.workload, args.seed, args.seconds, bool(args.trace),
              "cuda", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"modules that must not load were loaded: {bad}",
              file=sys.stderr)
        return 5
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(res), flush=True)
    return 0


def cache_env(here: str = registry.HERE) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    base = os.path.join(here, "_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base,
                                                     "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
