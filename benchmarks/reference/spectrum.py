"""The plain reference's k-mer spectrum: every k-window of every read, its
canonical ntHash key, counted, then the end sweep.

Semantics (CQF-deNoise with ``--endDeNoise``): a key's count is the number
of windows whose canonical key it is; the end sweep drops keys counted
once.  A sweep in mid-stream fires only once the distinct keys reach the
configuration's trigger; the reference refuses a job in which they would,
since the sweep's timing then depends on the store's merge cadence.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kmers

ROWS = 1 << 18


def window_keys(reads: torch.Tensor, k: int, key_bits: int, bits: int = 64):
    """Canonical keys of all windows, row-major, one int64 tensor."""
    out = []
    for a in range(0, reads.shape[0], ROWS):
        fh, rh = kmers.window_hashes(reads[a:a + ROWS], k, bits)
        out.append(kmers.key_of(fh, rh, key_bits).reshape(-1))
    return torch.cat(out)


def count_cap(key_bits: int) -> int:
    """The store's saturation count: the payload below the key holds a
    traveled bit and the count, whose all-ones value is reserved."""
    return min((1 << (64 - key_bits - 1)) - 2, 1 << 30)


def spectrum(reads: torch.Tensor, sizing: dict, bits: int = 64):
    """(keys, counts, total, distinct_before_sweep): keys ascending, int64
    tensors on the reads' device."""
    k, key_bits = sizing["k"], sizing["key_bits"]
    keys = window_keys(reads, k, key_bits, bits)
    total = keys.numel()
    uk, cnt = torch.unique(keys, sorted=True, return_counts=True)
    del keys
    distinct = uk.numel()
    if sizing["rounds"] > 0 and distinct >= sizing["trigger"]:
        raise ValueError(
            f"{distinct} distinct keys reach the mid-stream deNoise trigger "
            f"{sizing['trigger']}: the reference does not model a sweep's "
            f"timing")
    cnt = torch.clamp(cnt, max=count_cap(key_bits))
    if sizing["end_denoise"]:
        keep = cnt >= 2
        uk, cnt = uk[keep], cnt[keep]
    return uk, cnt, total, distinct


def lookup(keys: torch.Tensor, counts: torch.Tensor,
           q: torch.Tensor) -> torch.Tensor:
    """Count of each query key (0 where absent)."""
    if keys.numel() == 0:
        return torch.zeros_like(q)
    i = torch.searchsorted(keys, q).clamp(max=keys.numel() - 1)
    return torch.where(keys[i] == q, counts[i], torch.zeros_like(q))


def compare(prog_keys: np.ndarray, prog_counts: np.ndarray,
            ref_keys: torch.Tensor, ref_counts: torch.Tensor) -> dict:
    """Keys in one spectrum and not the other (a key the program holds
    twice counts once more), and shared keys whose counts differ."""
    dev = ref_keys.device
    pk = torch.from_numpy(np.asarray(prog_keys).view(np.int64)).to(dev)
    pc = torch.from_numpy(np.asarray(prog_counts, np.int64)).to(dev)
    pk, order = torch.sort(pk, stable=True)
    pc = pc[order]
    dup = int((pk[1:] == pk[:-1]).sum()) if pk.numel() > 1 else 0
    if ref_keys.numel() == 0:
        return {"keys_apart": pk.numel(), "counts_apart": 0}
    i = torch.searchsorted(ref_keys, pk).clamp(max=ref_keys.numel() - 1)
    found = ref_keys[i] == pk
    n_found = int(found.sum())
    only = (pk.numel() - n_found) + (ref_keys.numel() - (n_found - dup)) + dup
    wrong = int((pc[found] != ref_counts[i[found]]).sum())
    return {"keys_apart": int(only), "counts_apart": wrong}
