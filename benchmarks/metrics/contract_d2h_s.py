"""contract_d2h_s: the contraction's copies to the host, chain_next and the
node k-mer words (models/contiger.finalize_unitigs); the span
`contiger:contract.d2h`, seconds a job (the program's own phase times,
utils/profiling.GLOBAL.stats, read after each job; None where the span never
ran)."""

PHASES = ("contiger:contract.d2h",)


def read(ctx):
    seen = [sum(p[n] for n in PHASES if n in p) for p in ctx["phases"]
            if any(n in p for n in PHASES)]
    return sum(seen) / len(ctx["phases"]) if seen else None
