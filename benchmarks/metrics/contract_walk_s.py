"""contract_walk_s: the contraction's walk over the chain forest
(contract_paths_host, cpp/contract.cpp); the span `contiger:contract.walk`,
seconds a job (the program's own phase times, utils/profiling.GLOBAL.stats,
read after each job; None where the span never ran)."""

PHASES = ("contiger:contract.walk",)


def read(ctx):
    seen = [sum(p[n] for n in PHASES if n in p) for p in ctx["phases"]
            if any(n in p for n in PHASES)]
    return sum(seen) / len(ctx["phases"]) if seen else None
