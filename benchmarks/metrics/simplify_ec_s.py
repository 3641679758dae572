"""simplify_ec_s: the erroneous connections' removal
(models/simplify_arrays.ArrayGraph.remove_erroneous_connections), summed
over the simplification's rounds; the span `simplify.ec`, seconds a job (the
program's own phase times, utils/profiling.GLOBAL.stats, read after each
job; None where the span never ran)."""

PHASES = ("simplify.ec",)


def read(ctx):
    seen = [sum(p[n] for n in PHASES if n in p) for p in ctx["phases"]
            if any(n in p for n in PHASES)]
    return sum(seen) / len(ctx["phases"]) if seen else None
