"""contract_s: the contraction (contract_paths_host, cpp/contract.cpp),
seconds a job (the program's own phase times, utils/profiling.GLOBAL.stats,
read after each job)."""

PHASES = ("contiger:contract",)


def read(ctx):
    seen = [sum(p[n] for n in PHASES if n in p) for p in ctx["phases"]
            if any(n in p for n in PHASES)]
    return sum(seen) / len(ctx["phases"]) if seen else None
