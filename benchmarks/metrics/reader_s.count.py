"""reader_s.count: the reader's time to hand over a batch (io/native.py and
the cpp/ reader), summed over the pulls of the prefetch thread
(models/counter._prefetch), which runs beside the main thread; the span
`count:reader next`, seconds a job (the program's own phase times,
utils/profiling.GLOBAL.stats, read after each job; None where the span never
ran)."""

PHASES = ("count:reader next",)


def read(ctx):
    seen = [sum(p[n] for n in PHASES if n in p) for p in ctx["phases"]
            if any(n in p for n in PHASES)]
    return sum(seen) / len(ctx["phases"]) if seen else None
