"""The benchmark of sh_assembly_tpu_torch: one run of one cell.

  python benchmarks/run.py --workload <name> --seed <n> --seconds <s> \
      --trace <0|1>

Run from the root of a checkout.  The last line of standard output is the
run's result, one JSON object; the numbers compared with the plain
reference, each beside its limit, are the last lines of standard error.
Exits non-zero, with no result, when the cell's CUDA devices are missing,
when the program under test is not in the checkout, or when a JAX module
was loaded.  See benchmarks/README.md.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path[:0] = [HERE, ROOT]
    from shbench import runner

    runner.cache_env(HERE)
    return runner.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
