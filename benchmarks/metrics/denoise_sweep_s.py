"""denoise_sweep_s: the deNoise rounds' sweeps in a whole assembly, the spans
`count:merge.deNoise` (a sweep after a merge in mid-stream) and
`count:finalize merge+sweeps.deNoise` (the round on the last chunk; the end
sweep is not in it), seconds a job (the program's own phase times,
utils/profiling.GLOBAL.stats, read after each job; None where no sweep
span ran)."""

PHASES = ("count:merge.deNoise", "count:finalize merge+sweeps.deNoise")


def read(ctx):
    seen = [sum(p[n] for n in PHASES if n in p) for p in ctx["phases"]
            if any(n in p for n in PHASES)]
    return sum(seen) / len(ctx["phases"]) if seen else None
