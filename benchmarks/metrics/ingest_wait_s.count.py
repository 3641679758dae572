"""ingest_wait_s.count: the counter's wait on the reader, the main thread
blocked on the prefetch queue inside `count:host read/pack`
(models/counter.build_spectrum); the span `count:host read/pack.wait`, seconds
a job (the program's own phase times, utils/profiling.GLOBAL.stats, read after
each job; None where the span never ran)."""

PHASES = ("count:host read/pack.wait",)


def read(ctx):
    seen = [sum(p[n] for n in PHASES if n in p) for p in ctx["phases"]
            if any(n in p for n in PHASES)]
    return sum(seen) / len(ctx["phases"]) if seen else None
