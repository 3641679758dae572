"""Time kernels K1 (store merge) and K2 (count join) at the main path's
real shapes, the wrappers by CUDA events and their kernels by name.

    python -m sh_assembly_tpu_torch.profile.kernels [--device cuda]

The state is the counting stage's at C. elegans flags: a store of
2^29 slots with ~100 M live entries (key_bits 37) and a full buffer of a
quarter of the slots, half of it hitting stored keys, 5 % of it holes.
K1 folds the buffer in (merge) and sweeps the store's singletons (sweep),
each into a fresh tensor and into a reused output that held as much as
the store, as ``spectrum._fold`` hands it in.  K2 answers ascending
probes against the same store: 9 x 2^24 (the graph probes' density, 1.5
a live key), 2^22 and 2^18 (sparse: the store is searched, not streamed),
and 2^28 against every eighth key (22 a live key, the phantom closure's
density), beside ``torch.searchsorted`` on a prepared key column.  On a
CUDA device a ``torch.profiler`` pass gives each kernel's device time.
``--log2-capacity`` cuts the size for a CPU run, whose times mean nothing.

To compare two commits on one card, copy this file into the other
checkout's package and run both from their roots in one command; the
reused output is timed only where ``merge_dedup`` takes ``out``.
"""

from __future__ import annotations

import argparse
import inspect
import sys

import torch

from ..cli.cqf_denoise import resolve_device
from ..ops import bits, join_cuda as jc, merge_cuda as mc, spectrum as sp
from ..utils.logging import log
from ..utils.profiling import median_ms

KEY_BITS = 37


def big_case(device, n_live=100_000_000, n_buf=1 << 27, key_bits=KEY_BITS,
             capacity=1 << 29, seed=5):
    """One merge at the counting stage's real size, generated on the
    device: n_live distinct keys in the store, a full buffer of which half
    hits stored keys, 5% of slots empty.  Returns (store, sorted packed
    buffer, live entries, key_bits, capacity)."""
    g = torch.Generator(device=device).manual_seed(seed)
    keys = torch.unique(torch.randint(
        0, 1 << key_bits, (n_live + n_live // 50,), generator=g,
        device=device))[:n_live]
    n = keys.numel()
    counts = torch.randint(1, 200, (n,), generator=g, device=device)
    trav = torch.randint(0, 2, (n,), generator=g, device=device)
    kshift, cb = sp.payload_bits(key_bits), sp.cbits(key_bits)
    store = torch.full((capacity,), -1, dtype=torch.int64, device=device)
    store[:n] = (keys << kshift) | (trav << cb) | counts
    pick = torch.randint(0, n, (n_buf,), generator=g, device=device)
    fresh = torch.randint(0, 1 << key_bits, (n_buf,), generator=g,
                          device=device)
    u = torch.rand(n_buf, generator=g, device=device)
    buf = torch.where(u < 0.5, keys[pick], fresh)
    buf = torch.where(u > 0.95, -1, buf)
    del keys, counts, trav, pick, fresh, u
    return store, sp.sort_pack_buf(buf, key_bits), n, key_bits, capacity


def probe_keys(store, n_main, key_bits, n_q, seed=6):
    """n_q ascending probe keys against a store, half of them stored keys,
    with a sentinel tail of n_q / 64."""
    g = torch.Generator(device=store.device).manual_seed(seed)
    half = n_q // 2
    pick = torch.randint(0, n_main, (half,), generator=g, device=store.device)
    hits = bits.srl(store[pick], sp.payload_bits(key_bits))
    fresh = torch.randint(0, 1 << key_bits, (n_q - half - n_q // 64,),
                          generator=g, device=store.device)
    q = torch.sort(torch.cat([hits, fresh])).values
    return torch.cat([q, torch.full((n_q // 64,), -1, dtype=torch.int64,
                                    device=store.device)])


def kernel_times(fn, reps: int = 5) -> dict:
    """Device microseconds per call of every kernel ``fn`` launches, by
    the kernel's name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times: dict = {}
    for e in p.key_averages():
        if e.device_type == DeviceType.CUDA and e.device_time_total > 0:
            # "(anonymous namespace)::k_merge(Geo, ...)" -> "k_merge"
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0].split("::")[-1]
            times[name] = times.get(name, 0.0) + e.device_time_total / reps
    return times


def run(device, log2_capacity: int = 29) -> dict:
    C = 1 << log2_capacity
    cuda = torch.device(device).type == "cuda"
    store, buf, n, kb, _ = big_case(device, n_live=int(C * 0.18626),
                                    n_buf=C // 4, capacity=C)
    log(f"state: {n} live entries in 2^{log2_capacity} slots, buffer "
        f"{buf.numel()} ({int((buf != -1).sum())} live), key_bits {kb}")
    res = {}

    def timed(name, fn, reps=7):
        fn()  # warm-up (builds the kernel)
        res[name] = median_ms(fn, reps, device)
        by_kernel = ""
        if cuda:
            res[name + "_kernels_us"] = kernel_times(fn)
            by_kernel = "  [" + ", ".join(
                f"{k} {v:.0f} us"
                for k, v in res[name + "_kernels_us"].items()) + "]"
        log(f"{name}: {res[name]:.3f} ms{by_kernel}")

    # K1; a commit from before the reused output has no ``out`` to take
    reuse = "out" in inspect.signature(mc.merge_dedup).parameters
    out = torch.full((C,), -1, dtype=torch.int64, device=device) \
        if reuse else None
    for label, b, drop in (("merge", buf, False), ("sweep", buf[:0], True)):
        timed(f"K1 {label}, fresh output",
              lambda: mc.merge_dedup(store, b, n, kb, drop, C))
        if reuse:
            # out last held the store's n entries or this result's
            held = max(n, int(mc.merge_dedup(store, b, n, kb, drop, C,
                                             out=out, out_dirty=C)[1]))
            timed(f"K1 {label}, reused output",
                  lambda: mc.merge_dedup(store, b, n, kb, drop, C, out=out,
                                         out_dirty=held))
    del out, buf

    # K2 against the same store, then against every eighth of its keys
    skeys = bits.srl(store[:n], sp.payload_bits(kb))
    for n_q in (9 * (C >> 5), C >> 7, C >> 11):
        q = probe_keys(store, n, kb, n_q)
        timed(f"K2 {n_q} probes / {n} keys",
              lambda: jc.count_join(store, n, q, kb))
        qk = torch.where(q == -1, 0, q)
        timed(f"torch.searchsorted {n_q} probes / {n} keys",
              lambda: torch.searchsorted(skeys, qk), reps=3)
    del skeys
    thin = torch.full((C >> 3,), -1, dtype=torch.int64, device=device)
    n8 = min(-(-n // 8), thin.numel())
    thin[:n8] = store[:n:8][:n8]
    q = probe_keys(thin, n8, kb, C >> 1)
    timed(f"K2 {q.numel()} probes / {n8} keys",
          lambda: jc.count_join(thin, n8, q, kb))
    return res


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="profile.kernels")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--log2-capacity", type=int, default=29)
    args = p.parse_args(argv)
    run(resolve_device(args.device), args.log2_capacity)
    return 0


if __name__ == "__main__":
    sys.exit(main())
