"""simplify_build_s: the simplification's CSR graph built from the Contiger's
arrays (models/simplify_arrays.ArrayGraph.from_array_unitigs); the span
`simplify.build`, seconds a job (the program's own phase times,
utils/profiling.GLOBAL.stats, read after each job; None where the span never
ran)."""

PHASES = ("simplify.build",)


def read(ctx):
    seen = [sum(p[n] for n in PHASES if n in p) for p in ctx["phases"]
            if any(n in p for n in PHASES)]
    return sum(seen) / len(ctx["phases"]) if seen else None
