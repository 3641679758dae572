"""host_assembly_s: the host assembly (_finalize_host) and the FASTA dump,
seconds a job (the program's own phase times, utils/profiling.GLOBAL.stats,
read after each job)."""

PHASES = ("contiger:host assembly", "contiger:fasta dump")


def read(ctx):
    seen = [sum(p[n] for n in PHASES if n in p) for p in ctx["phases"]
            if any(n in p for n in PHASES)]
    return sum(seen) / len(ctx["phases"]) if seen else None
