"""host_dedup_s: the host assembly's mirror dedup (np.unique;
models/contiger._finalize_host); the span `contiger:host assembly.dedup`,
seconds a job (the program's own phase times, utils/profiling.GLOBAL.stats,
read after each job; None where the span never ran)."""

PHASES = ("contiger:host assembly.dedup",)


def read(ctx):
    seen = [sum(p[n] for n in PHASES if n in p) for p in ctx["phases"]
            if any(n in p for n in PHASES)]
    return sum(seen) / len(ctx["phases"]) if seen else None
