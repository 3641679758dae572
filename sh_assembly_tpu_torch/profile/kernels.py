"""Time kernels K1 (store merge), K2 (count join), K3 (node-store fold)
and K4 (window sort) at their real shapes, the wrappers by CUDA events and
their kernels by name.

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
density), beside ``torch.searchsorted`` on a prepared key column.

K3 folds sorted flush candidates into a node store of 2^24 slots (k = 47,
a tenth of the stored entries seeds) at three shapes.  The flush shape is
what a full flush of the Contiger hands it on a 12 Mbp genome at 30x,
measured on the card (``FLUSH``): a 12.1 M-entry store against a stream
of 59,768,832 entries, of which 48,933,362 are solid candidates, copies
of 11,875,993 distinct k-mers of which all but 49,410 are stored already,
and the rest a sentinel tail.  The first flush's shape is the same stream
against an empty store.  The small shape is 2^22 candidates with few
copies and a quarter of sentinels against 12 M stored entries.  K4 sorts
2^27 u32 values in windows of 2^17, beside ``torch.sort`` over the rows.

On a CUDA device a ``torch.profiler`` pass gives each kernel's device
time.  ``--log2-capacity`` cuts the size for a CPU run, whose times mean
nothing.

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
from ..ops import bits, blocksort_cuda as bs, join_cuda as jc, \
    kmerpack as kp, merge128_cuda as m3, merge_cuda as mc, spectrum as sp
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


def _k3_store(g, device, n_store, cap, k):
    """A sorted node store of n_store random k-mers in cap slots, a tenth
    of them seeds (nflag 0), a sentinel tail (nflag 1).  Returns (a_hi,
    a_lo, a_nf, rand_words, lo_mask)."""

    def rand_words(n):
        return torch.randint(-(1 << 63), (1 << 63) - 1, (n,), generator=g,
                             device=device)

    lo_mask = ~((1 << (128 - 2 * k)) - 1)
    hi, lo = rand_words(n_store), rand_words(n_store) & lo_mask
    perm = kp.sort_pairs(hi, lo)
    a_hi = torch.full((cap,), -1, dtype=torch.int64, device=device)
    a_lo = torch.full((cap,), -1, dtype=torch.int64, device=device)
    a_nf = torch.ones(cap, dtype=torch.uint8, device=device)
    a_hi[:n_store], a_lo[:n_store] = hi[perm], lo[perm]
    a_nf[:n_store] = (torch.rand(n_store, generator=g, device=device)
                      > 0.1).to(torch.uint8)
    return a_hi, a_lo, a_nf, rand_words, lo_mask


def _k3_sorted(b_hi, b_lo, b_nf):
    perm = kp.sort_pairs(b_hi, b_lo, b_nf)
    return (b_hi[perm].contiguous(), b_lo[perm].contiguous(),
            b_nf[perm].contiguous())


def k3_big_case(device, n_store=12_000_000, cap=1 << 24, n_b=1 << 22,
                k=47, seed=9):
    """One node-store fold at a small shape, generated on the device: a
    2^24-slot store with ~12 M live k-mers against 2^22 sorted candidates,
    half of them stored k-mers (few of them twice), a quarter sentinels.
    Returns merge128's arguments."""
    g = torch.Generator(device=device).manual_seed(seed)
    a_hi, a_lo, a_nf, rand_words, lo_mask = _k3_store(g, device, n_store,
                                                      cap, k)
    n_hit, n_sent = n_b // 2, n_b // 4
    pick = torch.randint(0, n_store, (n_hit,), generator=g, device=device)
    n_new = n_b - n_hit - n_sent
    sent = torch.full((n_sent,), -1, dtype=torch.int64, device=device)
    b_hi = torch.cat([a_hi[pick], rand_words(n_new), sent])
    b_lo = torch.cat([a_lo[pick], rand_words(n_new) & lo_mask, sent])
    b_nf = (torch.rand(n_b, generator=g, device=device) > 0.1).to(torch.uint8)
    b_nf[n_b - n_sent:] = 1
    return (a_hi, a_lo, a_nf, n_store, *_k3_sorted(b_hi, b_lo, b_nf), cap)


# The third of the Contiger's five flushes on a 12 Mbp genome at 30x of
# 150 bp reads (k = 47), measured on the card: the store the fold reads,
# the candidates staged, the solid ones among them (4.1 copies a k-mer,
# 1 % of them seeds), the distinct solid k-mers, and how many of those the
# store holds already.  The first four flushes stage as many; the first
# meets an empty store, the last stages 34,553,856.
FLUSH = dict(n_store=12_142_636, cap=1 << 24, n_b=59_768_832,
             n_solid=48_933_362, n_distinct=11_875_993, n_hit=11_826_583)


def k3_flush_case(device, n_store=FLUSH["n_store"], cap=FLUSH["cap"],
                  n_b=FLUSH["n_b"], n_solid=FLUSH["n_solid"],
                  n_distinct=FLUSH["n_distinct"], n_hit=FLUSH["n_hit"],
                  k=47, seed=10):
    """One node-store fold at the shape a flush hands it, generated on the
    device: the whole sorted candidate buffer of n_b entries, of which
    n_solid are copies of n_distinct k-mers (each at least once, 1 % of
    the copies seeds) and the rest the sentinel tail of the masked
    non-solid candidates; n_hit of the distinct k-mers are stored ones.
    Returns merge128's arguments; with ``na = 0`` in place of the fourth
    they are the first flush's, against an empty store."""
    g = torch.Generator(device=device).manual_seed(seed)
    a_hi, a_lo, a_nf, rand_words, lo_mask = _k3_store(g, device, n_store,
                                                      cap, k)
    pick = torch.randperm(n_store, generator=g, device=device)[:n_hit]
    d_hi = torch.cat([a_hi[pick], rand_words(n_distinct - n_hit)])
    d_lo = torch.cat([a_lo[pick], rand_words(n_distinct - n_hit) & lo_mask])
    copy = torch.cat([
        torch.arange(n_distinct, device=device),
        torch.randint(0, n_distinct, (n_solid - n_distinct,), generator=g,
                      device=device)])
    b_nf = (torch.rand(n_solid, generator=g, device=device) > 0.01).to(
        torch.uint8)
    b_hi, b_lo, b_nf = _k3_sorted(d_hi[copy], d_lo[copy], b_nf)
    del d_hi, d_lo, copy, pick
    sent = torch.full((n_b - n_solid,), -1, dtype=torch.int64, device=device)
    return (a_hi, a_lo, a_nf, n_store, torch.cat([b_hi, sent]),
            torch.cat([b_lo, sent]),
            torch.cat([b_nf, torch.ones(n_b - n_solid, dtype=torch.uint8,
                                        device=device)]), cap)


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
            name = name.removeprefix("void ")
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
    del store, thin, q, qk

    # K3: a node store of C / 32 slots (2^24 at the real size)
    f = (C >> 5) / FLUSH["cap"]
    shape = {key: int(v * f) for key, v in FLUSH.items()}
    small = k3_big_case(device, n_store=int(12_000_000 * f), cap=shape["cap"],
                        n_b=shape["cap"] >> 2)
    timed(f"K3 small shape, {small[3]} stored + {small[4].numel()}",
          lambda: m3.merge128(*small))
    del small
    args = k3_flush_case(device, **shape)
    log(f"flush shape: {args[3]} stored in {args[-1]} slots, "
        f"{args[4].numel()} candidates ({shape['n_solid']} solid, "
        f"{shape['n_distinct']} distinct, {shape['n_hit']} stored already)")
    for label, a in (("flush shape", args),
                     ("empty store", (*args[:3], 0, *args[4:]))):
        timed(f"K3 {label}", lambda: m3.merge128(*a))
    del args, a

    # K4: C / 4 values (2^27) in windows of C / 4096 (2^17)
    N, W = C >> 2, max(C >> 12, bs.LANES)
    x = torch.randint(-(1 << 31), (1 << 31) - 1, (N,), dtype=torch.int32,
                      generator=torch.Generator(device=device).manual_seed(7),
                      device=device)
    timed(f"K4 {N} values, windows of {W}", lambda: bs.block_sort(x, W))
    timed(f"torch.sort rows [{N // W}, {W}]",
          lambda: bs.block_sort_plain(x, W), reps=3)
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
