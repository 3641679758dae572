"""One fused counting step of the port, as a function and its inputs.

    python -m sh_assembly_tpu_torch.profile.entry [--device cuda]

Counterpart of ``__graft_entry__.entry``: ``entry()`` returns ``(fn,
example_args)`` for one device step of the k = 47 counting stage at qb =
25 (key_bits 33): the canonical ntHash of every window of a batch of 256
random reads of 160 bp (``np.random.default_rng(0)``), the key mask, and
the append to a spectrum's buffer (``counter.count_batch``, kernel K5 on
a CUDA device).  ``main`` runs the step once and logs what it appended.
(The multi-chip dry run is ``parallel/dryrun.py``.)
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..cli.cqf_denoise import resolve_device
from ..models import counter
from ..ops import spectrum as sp
from ..utils.logging import log

K, KEY_BITS = 47, 33
B, L = 256, 160
C, BC = 1 << 16, 1 << 15


def step(spec: sp.Spectrum, codes: torch.Tensor,
         lengths: torch.Tensor) -> sp.Spectrum:
    """Hash every window, mask the keys, append them (-1 where a window
    is not valid)."""
    return counter.count_batch(spec, codes, lengths, K, KEY_BITS)


def entry(device="cuda"):
    """(fn, example_args) of one counting step on ``device``."""
    rng = np.random.default_rng(0)
    codes = torch.from_numpy(
        rng.integers(0, 4, size=(B, L)).astype(np.uint8)).to(device)
    lengths = torch.full((B,), L, dtype=torch.int32, device=device)
    return step, (sp.make(C, BC, device), codes, lengths)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="profile.entry")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    fn, example = entry(resolve_device(args.device))
    spec = fn(*example)
    live = int((spec.buf[:spec.n_buf] != -1).sum())
    log(f"one counting step: {spec.n_buf} slots appended, {live} keys")
    return 0


if __name__ == "__main__":
    sys.exit(main())
