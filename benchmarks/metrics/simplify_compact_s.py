"""simplify_compact_s: the chain recompaction after each pass
(models/simplify_arrays.ArrayGraph.compact, three calls a round), summed
over the simplification's rounds; the span `simplify.compact`, seconds a job
(the program's own phase times, utils/profiling.GLOBAL.stats, read after
each job; None where the span never ran)."""

PHASES = ("simplify.compact",)


def read(ctx):
    seen = [sum(p[n] for n in PHASES if n in p) for p in ctx["phases"]
            if any(n in p for n in PHASES)]
    return sum(seen) / len(ctx["phases"]) if seen else None
