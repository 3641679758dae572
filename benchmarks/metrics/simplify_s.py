"""simplify_s: the simplification (models/simplify_arrays) and the contigs'
FASTA, seconds a job (the program's own phase times,
utils/profiling.GLOBAL.stats, read after each job)."""

PHASES = ("simplify",)


def read(ctx):
    seen = [sum(p[n] for n in PHASES if n in p) for p in ctx["phases"]
            if any(n in p for n in PHASES)]
    return sum(seen) / len(ctx["phases"]) if seen else None
