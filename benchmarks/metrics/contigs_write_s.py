"""contigs_write_s: the contigs' FASTA written
(models/simplify_arrays.write_contigs_arrays, called by cli/pipeline); the
span `simplify.write`, seconds a job (the program's own phase times,
utils/profiling.GLOBAL.stats, read after each job; None where the span never
ran)."""

PHASES = ("simplify.write",)


def read(ctx):
    seen = [sum(p[n] for n in PHASES if n in p) for p in ctx["phases"]
            if any(n in p for n in PHASES)]
    return sum(seen) / len(ctx["phases"]) if seen else None
