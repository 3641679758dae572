"""early_merge_s: the merges that the near-trigger rule fires before the
buffer is full, so that a deNoise sweep fires close to its trigger; the span
`count:merge.early` (the merge alone, its sweep is in denoise_sweep_s),
seconds a job (the program's own phase times, utils/profiling.GLOBAL.stats,
read after each job; None where the span never ran)."""

PHASES = ("count:merge.early",)


def read(ctx):
    seen = [sum(p[n] for n in PHASES if n in p) for p in ctx["phases"]
            if any(n in p for n in PHASES)]
    return sum(seen) / len(ctx["phases"]) if seen else None
