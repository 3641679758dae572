"""count_s.pipeline: the whole counting stage of a pipeline job (reader, K5,
merges, sweeps), seconds a job (the program's own phase times,
utils/profiling.GLOBAL.stats, read after each job)."""

PHASES = ("count:host read/pack", "count:device append", "count:merge",
          "count:finalize merge+sweeps")


def read(ctx):
    seen = [sum(p[n] for n in PHASES if n in p) for p in ctx["phases"]
            if any(n in p for n in PHASES)]
    return sum(seen) / len(ctx["phases"]) if seen else None
