"""Time buffer-sort variants with ``torch.sort`` (the yardsticks for kernel
K4 and for a hand-written buffer sort).

    python -m sh_assembly_tpu_torch.profile.sort [--device cuda]

Counterpart of ``profile_sort.py``.  BC = 2^27 keys of key_bits 36 as a
4-bit hi word and a u32 lo word from ``np.random.default_rng(0)``:

  A. pair (hi, lo) flat: two stable sorts, minor key first
  B. one int64 word hi << 32 | lo, flat
  C. lo alone, flat (a cost probe, not the buffer sort's semantics)
  D. lo as rows [256, BC / 256]
  E. lo as rows [64, BC / 64]
  F. lo as rows [1024, BC / 1024]
  G. pair rows [256, BC / 256]: two stable sorts along the rows
  H. lo as rows [4096, BC / 4096]

32-bit words sort as int32 and the 64-bit word as int64, top bit flipped
(``ops/bits``).  A variant that fails raises.  ``--log2-n`` cuts the size
for a CPU run.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..cli.cqf_denoise import resolve_device
from ..ops import bits
from ..utils.logging import log
from ..utils.profiling import maybe_trace, median_ms

KEY_BITS = 36

def make_input(log2_n: int):
    """The script's input: (hi, lo) numpy u32 arrays from seed 0."""
    rng = np.random.default_rng(0)
    n = 1 << log2_n
    hi = rng.integers(0, 1 << (KEY_BITS - 32), size=n).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    return hi, lo


def _sort_pairs(hi: torch.Tensor, lo: torch.Tensor, dim: int):
    """Lexicographic (hi, lo) sort along ``dim``: stable sorts, minor key
    first.  hi and lo are order-mapped int32 (top bit flipped)."""
    lo1, o1 = torch.sort(lo, dim=dim, stable=True)
    hi2, o2 = torch.sort(torch.gather(hi, dim, o1), dim=dim, stable=True)
    return hi2, torch.gather(lo1, dim, o2)


def _word(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """hi << 32 | lo as one order-mapped int64 word, from order-mapped
    int32 planes (hi's flipped top bit becomes the word's)."""
    return (hi.long() << 32) | (bits.flip32(lo).long() & 0xFFFFFFFF)


def _rows(g: int):
    return lambda hi, lo: (torch.sort(lo.view(g, -1), dim=1).values,)


# name -> fn(hi, lo) on order-mapped int32 tensors; returns sorted tensors
VARIANTS = [
    ("A pair (hi,lo) flat", lambda hi, lo: _sort_pairs(hi, lo, 0)),
    ("B u64 flat", lambda hi, lo: (torch.sort(_word(hi, lo)).values,)),
    ("C u32 flat", lambda hi, lo: (torch.sort(lo).values,)),
    ("D u32 rows [256,.]", _rows(256)),
    ("E u32 rows [64,.]", _rows(64)),
    ("F u32 rows [1024,.]", _rows(1024)),
    ("G pair rows [256,.]", lambda hi, lo: _sort_pairs(
        hi.view(256, -1), lo.view(256, -1), 1)),
    ("H u32 rows [4096,.]", _rows(4096)),
]


def run(device, log2_n: int = 27) -> dict:
    if log2_n < 12:
        raise ValueError("need at least 2^12 keys (4096 rows in variant H)")
    n = 1 << log2_n
    hi_np, lo_np = make_input(log2_n)
    hi = bits.flip32(torch.from_numpy(hi_np.view(np.int32)).to(device))
    lo = bits.flip32(torch.from_numpy(lo_np.view(np.int32)).to(device))
    times = {}
    for name, fn in VARIANTS:
        fn(hi, lo)  # warm-up
        ms = median_ms(lambda: fn(hi, lo), 3, device)
        times[name] = ms
        log(f"{name} 2^{log2_n}: {ms:.3f} ms  ({n / ms / 1e3:.0f} M elem/s)")
    return times


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="profile.sort")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--log2-n", type=int, default=27)
    args = p.parse_args(argv)
    with maybe_trace():  # SH_ASSEMBLY_TRACE_DIR: a Chrome trace
        run(resolve_device(args.device), args.log2_n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
