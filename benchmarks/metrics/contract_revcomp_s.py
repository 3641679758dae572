"""contract_revcomp_s: the contraction's reverse complements of the node
k-mers (kmerpack.revcomp_packed); the span `contiger:contract.revcomp`,
seconds a job (the program's own phase times, utils/profiling.GLOBAL.stats,
read after each job; None where the span never ran)."""

PHASES = ("contiger:contract.revcomp",)


def read(ctx):
    seen = [sum(p[n] for n in PHASES if n in p) for p in ctx["phases"]
            if any(n in p for n in PHASES)]
    return sum(seen) / len(ctx["phases"]) if seen else None
