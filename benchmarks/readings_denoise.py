"""Readings of the comparison of a cell whose entry models the deNoise
sweeps (entry ``pipeline_denoise``), from which its limits are set: for
each seed, one job of the program at the cell's own size judged against the
plain reference, then two controls judged the same way, each the reference
in the program's place: its hash in 32-bit words (the hash control), and
its near-trigger rule off, so that its sweeps fire at other times (the
cadence control).  Not part of a benchmark run.

  python benchmarks/readings_denoise.py --workload ecoli.pipeline.100x --seeds 1 2 3

One JSON line a seed on standard output: {"seed", "job", "program",
"control", "cadence_control"}; "job" holds the program's own counters, the
others the numbers compared.  (``readings.py``'s control takes the
reference without sweeps, which refuses such a cell.)
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CONTROLS = (("control", {"bits": 32}),
            ("cadence_control", {"near_trigger": False}))


def readings(workload: str, seed: int, device: str, root: str = ROOT,
             here: str = HERE) -> dict:
    import torch

    from shbench import generate, registry

    cell = registry.resolve(workload, root, here)
    config, traffic, entry_mod = cell["config"], cell["traffic"], \
        cell["entry"]
    work = tempfile.mkdtemp(prefix="shbench-readings-")
    try:
        reads = generate.make_reads(seed, config, traffic)
        lst = generate.write_job_files(work, "reads", reads)
        ctx = {"config": config, "traffic": traffic, "device": device,
               "workdir": work, "n_reads": reads.shape[0]}
        entry = entry_mod.Entry(ctx)
        jobs = [entry.job(lst)]
        entry.collect(jobs)
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        rd = torch.from_numpy(reads).to(device)
        out = {"seed": seed, "job": jobs[0], "program": entry.judge(rd)[0]}
        for name, kw in CONTROLS:
            entry_mod.control_outputs(entry, rd, os.path.join(work, name),
                                      **kw)
            out[name] = entry.judge(rd)[0]
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path[:0] = [HERE, ROOT]
    from shbench import runner

    runner.cache_env(HERE)
    for s in args.seeds:
        print(json.dumps(readings(args.workload, s, "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
