"""Time kernel K7 (the node join) at the Contiger's real shapes, split by
kernel name, and every K7 call of a pipeline run.

    python -m sh_assembly_tpu_torch.profile.node_join [--device cuda]
    python -m sh_assembly_tpu_torch.profile.node_join --pipeline -- ARGS

The shapes: the graph probe of ``profile.stage2``'s 2^24 node k-mers (their
8 x 2^24 successor words as queries, made by kernel K8); closure round 1
over the padded store of a 12 Mbp genome at 30x (the first 12,232,221 of
those k-mers, then sentinel pad rows to 2^24; the 16 x 2^24 closure-mode
probes as queries); and two later closure rounds over that store, a
frontier of 50,000 nodes padded to 2^22 (16 x 2^22 queries) and one of
5,000 padded to 2^14 (16 x 2^14).  Each is one call of ``kmerpack.join2``,
which on the card is K7's one-shot route (a table built for the call and
probed): its device time (10 calls queued behind a spin kernel), each
kernel's device time by name (a ``torch.profiler`` pass) and the queries
found.  Every version of K7 has that route, so this file, copied with
``utils/profiling.py`` into another checkout, times that commit the same
way.

``--pipeline`` runs ``cli.pipeline`` with ARGS and times every call into
K7's library (CUDA events around each C entry that ``node_join_cuda``
bound), then prints each call's entry, its size arguments and its device
time in order, and their sum.

``--log2-n`` cuts the shapes for a CPU run (``--device cpu``), whose times
mean nothing.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import sys

import torch

from ..cli.cqf_denoise import resolve_device
from ..ops import bits, kmerpack as kp, node_join_cuda, probe_cuda
from ..utils.logging import log
from ..utils.profiling import median_ms, queued_ms
from . import kernels, stage2

# The numbers of the last run() or pipeline() in this process.
LAST: dict = {}

K, KEY_BITS = stage2.K, 36
CLOSURE_REAL = 12_232_221  # nodes of the 12 Mbp genome's closure store
LATER = ((22, 50_000), (14, 5_000))  # (log2 frontier pad, frontier nodes)


def shapes(device, log2_n: int = 24):
    """(name, table_hi, table_lo, q_hi, q_lo) of the four shapes, built on
    ``device``; at a cut size the closure store keeps the same share of
    real rows and the frontiers the same share of the store."""
    hp, lp = stage2.node_kmers(log2_n)
    hi, lo = bits.from_u64_np(hp, device), bits.from_u64_np(lp, device)
    del hp, lp
    N = hi.numel()
    real = CLOSURE_REAL * N >> 24
    chi, clo = hi.clone(), lo.clone()
    chi[real:], clo[real:] = -1, -1

    def queries(h, l, mode):
        _, qh, ql, _ = probe_cuda.node_probes(h, l, K, KEY_BITS, mode)
        return qh.reshape(-1), ql.reshape(-1)

    yield ("graph", hi, lo, *queries(hi, lo, "graph"))
    yield ("closure round 1", chi, clo, *queries(chi, clo, "closure"))
    for log2_pad, n in LATER:
        pad = max(1 << (log2_pad + log2_n - 24), 1024)
        n = max(n * N >> 24, 1)
        fh = torch.full((pad,), -1, dtype=torch.int64, device=device)
        fl = fh.clone()
        fh[:n], fl[:n] = chi[real - n:real], clo[real - n:real]
        yield (f"later round, {n} nodes padded to {pad}", chi, clo,
               *queries(fh, fl, "closure"))


def run(device, log2_n: int = 24) -> dict:
    cuda = torch.device(device).type == "cuda"
    res = {}
    for name, th, tl, qh, ql in shapes(device, log2_n):
        def fn():
            return kp.join2(th, tl, qh, ql)

        found = int((fn() >= 0).sum())
        r = dict(rows=th.numel(), queries=qh.numel(), found=found,
                 ms=queued_ms(fn, 10) if cuda else median_ms(fn, 3, device))
        if cuda:
            r["kernels_ms"] = {k: v / 1e3
                               for k, v in kernels.kernel_times(fn).items()}
        res[name] = r
        log(f"K7 {name}: {r['rows']} rows, {r['queries']} queries, "
            f"{found} found; {r['ms']:.4f} ms"
            + "".join(f", {k} {v:.4f} ms"
                      for k, v in r.get("kernels_ms", {}).items()))
        del th, tl, qh, ql
    return res


@contextlib.contextmanager
def timed_calls():
    """CUDA events around every call into K7's library while the block
    runs -> the list of calls, each (entry, its integer arguments, start
    event, end event), read after a synchronise."""
    lib = node_join_cuda._load()
    calls = []
    saved = {name: fn for name, fn in vars(lib).items()
             if isinstance(fn, ctypes._CFuncPtr)}

    def timed(name, fn):
        ints = [i for i, t in enumerate(fn.argtypes)
                if t in (ctypes.c_longlong, ctypes.c_int)]

        def call(*args):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            rc = fn(*args)
            b.record()
            calls.append((name, [args[i] for i in ints], a, b))
            return rc
        return call

    for name, fn in saved.items():
        setattr(lib, name, timed(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(lib, name, fn)


def pipeline(args: list[str]) -> dict:
    from ..cli import pipeline as cli

    # one join first loads K7's kernels (CUDA loads a module at its first
    # launch), so that the timed calls are device work
    t = torch.zeros(1, dtype=torch.int64, device="cuda")
    kp.join2(t, t, t, t)
    with timed_calls() as calls:
        rc = cli.main(args)
    torch.cuda.synchronize()
    out = [dict(entry=name, args=ints, ms=a.elapsed_time(b))
           for name, ints, a, b in calls]
    for i, c in enumerate(out):
        log(f"K7 call {i}: {c['entry']}{tuple(c['args'])} {c['ms']:.4f} ms")
    total = sum(c["ms"] for c in out)
    log(f"K7: {len(out)} calls into its library, {total:.4f} ms of device "
        f"time")
    return dict(rc=rc, calls=out, total_ms=total)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    rest = []
    if "--" in argv:
        at = argv.index("--")
        argv, rest = argv[:at], argv[at + 1:]
    p = argparse.ArgumentParser(prog="profile.node_join")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--log2-n", type=int, default=24)
    p.add_argument("--pipeline", action="store_true",
                   help="time every K7 call of cli.pipeline on the "
                        "arguments after --")
    args = p.parse_args(argv)
    LAST.clear()
    if args.pipeline:
        LAST.update(pipeline(rest))
        return LAST["rc"]
    LAST.update(run(resolve_device(args.device), args.log2_n))
    return 0


if __name__ == "__main__":
    sys.exit(main())
