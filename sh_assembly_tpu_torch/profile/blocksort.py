"""Time kernel K4, the window sort, beside the plain ``torch.sort`` rows.

    python -m sh_assembly_tpu_torch.profile.blocksort [--device cuda]

Counterpart of ``profile_blocksort.py``: N = 2^27 u32 values from
``np.random.default_rng(0)`` are sorted in independent windows of
W = 2^17 by ``ops.blocksort_cuda.block_sort`` (kernel K4 on a CUDA
device).  Logs the kernel's median time, ns/element and ps/element/stage
(a window's bitonic network has log2(W) (log2(W) + 1) / 2 stages), the
checksum over every 65536th value, the plain version's median beside it,
and checks two windows against ``np.sort`` and the whole output against
the plain version.  A failure raises.  ``--log2-n`` and ``--log2-w`` cut
the size for a CPU run.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..cli.cqf_denoise import resolve_device
from ..ops import blocksort_cuda as bs
from ..utils.logging import log
from ..utils.profiling import maybe_trace, median_ms

# The numbers of the last run() in this process, for callers of main().
LAST: dict = {}


def make_input(log2_n: int) -> np.ndarray:
    """The script's input: 2^log2_n u32 values from seed 0."""
    rng = np.random.default_rng(0)
    return rng.integers(0, 1 << 32, size=1 << log2_n,
                        dtype=np.uint64).astype(np.uint32)


def run(device, log2_n: int = 27, log2_w: int = 17) -> dict:
    N, W = 1 << log2_n, 1 << log2_w
    if log2_n <= log2_w:
        raise ValueError("need at least two windows")
    xnp = make_input(log2_n)
    x = torch.from_numpy(xnp.view(np.int32)).to(device)

    out = bs.block_sort(x, W)  # also the warm-up (builds the kernel)
    chk = int(out[::65536].long().bitwise_and(0xFFFFFFFF).sum())
    ms = median_ms(lambda: bs.block_sort(x, W), 7, device)
    plain = bs.block_sort_plain(x, W)
    plain_ms = median_ms(lambda: bs.block_sort_plain(x, W), 3, device)
    stages = log2_w * (log2_w + 1) // 2
    log(f"blocksort W=2^{log2_w}: {ms:.3f} ms  ({ms / N * 1e6:.4f} ns/elem, "
        f"{stages} stages -> {ms / N / stages * 1e9:.3f} ps/elem/stage) "
        f"chk={chk}")
    log(f"torch.sort rows [{N // W}, 2^{log2_w}]: {plain_ms:.3f} ms  "
        f"({plain_ms / N * 1e6:.4f} ns/elem)")

    got = out[:2 * W].cpu().numpy().view(np.uint32)
    want = np.concatenate([np.sort(xnp[:W]), np.sort(xnp[W:2 * W])])
    if not np.array_equal(got, want):
        raise AssertionError("block_sort != np.sort on the first two windows")
    if not torch.equal(out, plain):
        raise AssertionError(
            f"block_sort != torch.sort rows: "
            f"{int((out != plain).sum())} of {N} values differ")
    log("  correct: True")
    return dict(n=N, w=W, ms=ms, plain_ms=plain_ms, chk=chk)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="profile.blocksort")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--log2-n", type=int, default=27)
    p.add_argument("--log2-w", type=int, default=17)
    args = p.parse_args(argv)
    LAST.clear()
    with maybe_trace():  # SH_ASSEMBLY_TRACE_DIR: a Chrome trace
        LAST.update(run(resolve_device(args.device), args.log2_n,
                        args.log2_w))
    return 0


if __name__ == "__main__":
    sys.exit(main())
