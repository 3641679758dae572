"""collect_wait_s: the Contiger's collect waiting on its stream of batches (in
the pipeline, the second decode of the FASTQ; models/contiger.collect_nodes);
the span `contiger:collect nodes.wait`, seconds a job (the program's own phase
times, utils/profiling.GLOBAL.stats, read after each job; None where the span
never ran)."""

PHASES = ("contiger:collect nodes.wait",)


def read(ctx):
    seen = [sum(p[n] for n in PHASES if n in p) for p in ctx["phases"]
            if any(n in p for n in PHASES)]
    return sum(seen) / len(ctx["phases"]) if seen else None
