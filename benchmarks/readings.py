"""Readings of the comparison, from which its limits are set: for each seed,
one job of the program at the cell's own size judged against the plain
reference, then the control (the reference in the program's place, its
hash in 32-bit words) judged the same way.  Not part of a benchmark run.

  python benchmarks/readings.py --workload <name> --seeds 1 2 3 [--no-control]

One JSON line a seed on standard output: {"seed", "program", "control"},
each a dict of the numbers compared.
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


def readings(workload: str, seed: int, device: str, control: bool,
             root: str = ROOT, here: str = HERE) -> dict:
    import torch

    from shbench import control as ctl, generate, registry

    cell = registry.resolve(workload, root, here)
    config, traffic = cell["config"], cell["traffic"]
    work = tempfile.mkdtemp(prefix="shbench-readings-")
    try:
        reads = generate.make_reads(seed, config, traffic)
        lst = generate.write_job_files(work, "reads", reads)
        ctx = {"config": config, "traffic": traffic, "device": device,
               "workdir": work, "n_reads": reads.shape[0]}
        entry = cell["entry"].Entry(ctx)
        jobs = [entry.job(lst)]
        entry.collect(jobs)
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        rd = torch.from_numpy(reads).to(device)
        out = {"seed": seed, "program": entry.judge(rd)[0]}
        if control:
            ctl.control_outputs(entry, rd, os.path.join(work, "control"))
            out["control"] = entry.judge(rd)[0]
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--no-control", action="store_true")
    args = p.parse_args(argv)
    sys.path[:0] = [HERE, ROOT]
    from shbench import runner

    runner.cache_env(HERE)
    for s in args.seeds:
        print(json.dumps(readings(args.workload, s, "cuda",
                                  not args.no_control)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
