"""counter_device_s.count: the counter's device work (models/counter.py: K5
append, buffer sort and K1 merges, sweeps), seconds a job (the program's
own phase times, utils/profiling.GLOBAL.stats, read after each job)."""

PHASES = ("count:device append", "count:merge",
          "count:finalize merge+sweeps")


def read(ctx):
    seen = [sum(p[n] for n in PHASES if n in p) for p in ctx["phases"]
            if any(n in p for n in PHASES)]
    return sum(seen) / len(ctx["phases"]) if seen else None
