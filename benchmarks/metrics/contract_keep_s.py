"""contract_keep_s: the contraction's mirror keep rule (_path_summary_np); the
span `contiger:contract.keep rule`, seconds a job (the program's own phase
times, utils/profiling.GLOBAL.stats, read after each job; None where the span
never ran)."""

PHASES = ("contiger:contract.keep rule",)


def read(ctx):
    seen = [sum(p[n] for n in PHASES if n in p) for p in ctx["phases"]
            if any(n in p for n in PHASES)]
    return sum(seen) / len(ctx["phases"]) if seen else None
