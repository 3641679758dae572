"""collect_s: the Contiger's node collection (models/contiger.collect_nodes:
K6, K2, K3), seconds a job (the program's own phase times,
utils/profiling.GLOBAL.stats, read after each job)."""

PHASES = ("contiger:collect nodes",)


def read(ctx):
    seen = [sum(p[n] for n in PHASES if n in p) for p in ctx["phases"]
            if any(n in p for n in PHASES)]
    return sum(seen) / len(ctx["phases"]) if seen else None
