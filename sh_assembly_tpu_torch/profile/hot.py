"""Take the counting hot path apart: hash, append, the buffer sort and K1.

    python -m sh_assembly_tpu_torch.profile.hot [--device cuda]

Counterpart of ``profile_hot.py``, at its geometry: k = 47, qb = 28
(C = 2^28 slots, key_bits 36), a buffer of BC = 2^27 slots, S = 8 batches
of 8192 reads of 160 bp drawn from an 8 Mbp random genome
(``np.random.default_rng(1)``), 2-bit packed as the native reader hands
them over.  Times (CUDA-event medians on a CUDA device):

  1. unpack and hash alone: ``packio.unpack`` and
     ``nthash.windowed_canonical`` over the S batches
  2. hash and append with no merge: ``counter.append_scan_packed`` of the
     S-stack into an empty buffer, one launch of kernel K5 on a CUDA
     device (the log line gives K5's launches)
  3. the buffer sort at BC and BC / 4 keys: ``profile.sort``'s variants
  4. K1 alone on presorted input (``profile.kernels.big_case``: half the
     slots live, a full sorted buffer): ns a key, M keys/s and the
     effective GB/s of 16 bytes a slot of store and buffer

Logs each with its key count.  ``--log2-capacity``, ``--log2-buf``,
``--rows`` and ``--stacks`` cut the size for a CPU run, whose times mean
nothing.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..cli.cqf_denoise import resolve_device
from ..models import counter
from ..ops import hash_append_cuda, merge_cuda, nthash, packio, \
    spectrum as sp
from ..utils.logging import log
from ..utils.profiling import median_ms
from . import kernels, sort

# The numbers of the last run() in this process, for callers of main().
LAST: dict = {}

K, L = 47, 160


def make_input(S: int, B: int, genome_len: int = 8_000_000):
    """S batches of B reads of L bp from a random genome, seed 1, packed:
    (packed [S, B, L/4], nmask [S, B, L/8], lengths [S, B]) numpy."""
    rng = np.random.default_rng(1)
    genome = rng.integers(0, 4, size=genome_len).astype(np.uint8)
    starts = rng.integers(0, genome_len - L, size=(S, B))
    codes = genome[starts[..., None] + np.arange(L)]
    packed, nmask = packio.pack_np(codes)
    return packed, nmask, np.full((S, B), L, np.int32)


def run(device, log2_capacity: int = 28, log2_buf: int = 27,
        rows: int = 8192, stacks: int = 8, reps: int = 3) -> dict:
    key_bits = log2_capacity + 8
    C, BC = 1 << log2_capacity, 1 << log2_buf
    W = L - K + 1
    n_keys = stacks * rows * W
    packed, nmask, lengths = (torch.from_numpy(a).to(device)
                              for a in make_input(stacks, rows))
    res = dict(keys=n_keys)

    def hash_only():
        # the sum of the masked keys consumes every hash (no wrap: a key
        # has key_bits <= 56 bits)
        total = torch.zeros((), dtype=torch.int64, device=device)
        for s in range(stacks):
            keys, valid = nthash.windowed_canonical(
                packio.unpack(packed[s], nmask[s], L), lengths[s], K)
            total += torch.where(valid, nthash.mask_keys(keys, key_bits),
                                 0).sum()
        return total

    res["key_sum"] = int(hash_only())
    res["hash_ms"] = median_ms(hash_only, reps, device)
    log(f"unpack + hash: {res['hash_ms']:.3f} ms for {n_keys} keys = "
        f"{res['hash_ms'] * 1e6 / n_keys:.3f} ns/key "
        f"({n_keys / res['hash_ms'] / 1e3:.0f} M keys/s)")

    if stacks * rows * W > BC:
        raise ValueError(f"{stacks} batches append {n_keys} slots but the "
                         f"buffer holds {BC}; lower --stacks or --rows")
    fresh = sp.make(1 << 10, BC, device)

    def append():
        return counter.append_scan_packed(fresh, packed, nmask, lengths, K,
                                          key_bits, L)

    launches = hash_append_cuda.LAUNCHES
    res["appended"] = append().n_buf
    res["append_ms"] = median_ms(append, reps, device)
    res["k5_launches"] = hash_append_cuda.LAUNCHES - launches
    log(f"hash + append (no merge): {res['append_ms']:.3f} ms = "
        f"{res['append_ms'] * 1e6 / n_keys:.3f} ns/key "
        f"({n_keys / res['append_ms'] / 1e3:.0f} M keys/s); K5 launches "
        f"{res['k5_launches']}")
    del fresh, packed, nmask, lengths

    res["sort_ms"] = {n: sort.run(device, n)
                      for n in (log2_buf, log2_buf - 2)}

    store, buf, n_live, kb, _ = kernels.big_case(
        device, n_live=C // 2, n_buf=BC, key_bits=key_bits, capacity=C)

    def k1():
        return merge_cuda.merge_dedup(store, buf, n_live, kb, False, C)

    res["n_live"] = int(k1()[1])
    ms = res["k1_ms"] = median_ms(k1, reps, device)
    n_el = C + BC
    log(f"K1 pass: {ms:.3f} ms for {n_el} slots (store {C}, buffer {BC}) "
        f"= {ms * 1e6 / n_el:.4f} ns/slot ({n_el / ms / 1e3:.0f} M "
        f"slots/s), {16 * n_el / ms / 1e6:.1f} GB/s effective; "
        f"{res['n_live']} live after the merge")
    return res


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="profile.hot")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--log2-capacity", type=int, default=28)
    p.add_argument("--log2-buf", type=int, default=27)
    p.add_argument("--rows", type=int, default=8192)
    p.add_argument("--stacks", type=int, default=8)
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args(argv)
    LAST.clear()
    LAST.update(run(resolve_device(args.device), args.log2_capacity,
                    args.log2_buf, args.rows, args.stacks, args.reps))
    return 0


if __name__ == "__main__":
    sys.exit(main())
