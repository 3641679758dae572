"""The plain reference's k-mer spectrum with CQF-deNoise's mid-stream
sweeps: the keys a sweep drops depend on when it fires, so this reference
models the counting stage's merge cadence from the geometry that the
configuration states, and takes nothing from the program.

Semantics (CQF-deNoise with ``--endDeNoise``, one read a row):

- Reads are taken in file order and cut into batches of ``batch_rows``
  reads.  Each batch adds ``batch_rows x (row_len - k + 1)`` slots to the
  buffer's count, padding and the last batch's empty rows included.
- Before each batch, a fold fires when the batch would overflow the
  buffer's ``buffer_slots``; else, while rounds remain and the near-trigger
  rule is on, when the buffer holds at least ``buffer_slots // 4`` slots
  and the distinct keys of the last fold plus the buffer's slots reach the
  trigger.
- A fold adds the buffered keys' counts to the store's, capped at
  ``spectrum.count_cap``.  After each fold, while rounds remain and the
  distinct keys reach the trigger, a sweep drops the keys counted once and
  uses up a round.
- At the end: a fold, the trigger test once more, then the end sweep.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import spectrum as ref_spectrum


@dataclass
class Result:
    keys: torch.Tensor  # int64, ascending
    counts: torch.Tensor  # int64
    rounds: int  # mid-stream sweeps fired (the last chunk's included)
    swept: int  # keys those sweeps dropped
    merges: int  # folds, the last one included
    early_merges: int  # folds the near-trigger rule fired


def _fold(keys, counts, new, cap: int):
    """The store (keys, counts) with the buffered keys ``new`` counted in."""
    nk, nc = torch.unique(new, sorted=True, return_counts=True)
    uk, inv = torch.unique(torch.cat([keys, nk]), sorted=True,
                           return_inverse=True)
    uc = torch.zeros_like(uk).scatter_add_(0, inv, torch.cat([counts, nc]))
    return uk, uc.clamp_(max=cap)


def spectrum(reads: torch.Tensor, sizing: dict, geometry: dict,
             bits: int = 64, near_trigger: bool = True) -> Result:
    """The spectrum after the end sweep, with the mid-stream sweeps at the
    stated cadence.  ``near_trigger=False`` leaves out the near-trigger
    rule: a fold fires only when the buffer is full."""
    k, key_bits = sizing["k"], sizing["key_bits"]
    rows, row_len = int(geometry["batch_rows"]), int(geometry["row_len"])
    slots = int(geometry["buffer_slots"])
    if reads.shape[1] > row_len:
        raise ValueError(f"reads of {reads.shape[1]} bases do not fit rows "
                         f"of {row_len}: the program would tile them")
    per_batch = rows * (row_len - k + 1)
    if 2 * per_batch > slots:
        raise ValueError(f"a buffer of {slots} slots does not hold two "
                         f"batches of {per_batch}")
    cap = ref_spectrum.count_cap(key_bits)
    rounds_left, trigger = sizing["rounds"], sizing["trigger"]
    dev = reads.device
    keys = torch.empty(0, dtype=torch.int64, device=dev)
    counts = torch.empty(0, dtype=torch.int64, device=dev)
    res = Result(keys, counts, 0, 0, 0, 0)
    start, n_buf = 0, 0  # first read not yet folded; the buffer's slots

    def fold(end: int):
        nonlocal keys, counts, start, n_buf, rounds_left
        new = ref_spectrum.window_keys(reads[start:end], k, key_bits, bits) \
            if end > start else keys[:0]
        keys, counts = _fold(keys, counts, new, cap)
        start, n_buf = end, 0
        res.merges += 1
        if rounds_left > 0 and keys.numel() >= trigger:
            keep = counts >= 2
            res.rounds += 1
            res.swept += keys.numel() - int(keep.sum())
            keys, counts = keys[keep], counts[keep]
            rounds_left -= 1

    n = reads.shape[0]
    for a in range(0, n, rows):
        if n_buf + per_batch > slots:
            fold(a)
        elif (near_trigger and rounds_left > 0 and n_buf >= slots // 4
              and keys.numel() + n_buf >= trigger):
            res.early_merges += 1
            fold(a)
        n_buf += per_batch
    fold(n)
    if sizing["end_denoise"]:
        keep = counts >= 2
        keys, counts = keys[keep], counts[keep]
    res.keys, res.counts = keys, counts
    return res
