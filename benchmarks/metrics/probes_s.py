"""probes_s: the Contiger's probes (phantom closure and graph: K8, K7, K2),
seconds a job (the program's own phase times, utils/profiling.GLOBAL.stats,
read after each job)."""

PHASES = ("contiger:phantom closure", "contiger:probe graph")


def read(ctx):
    seen = [sum(p[n] for n in PHASES if n in p) for p in ctx["phases"]
            if any(n in p for n in PHASES)]
    return sum(seen) / len(ctx["phases"]) if seen else None
