"""A configuration's flags, and the sizing it states, as each side reads
them.

The program gets the CLI flags (``flags`` of the configuration, ``-n`` and
``-N``); the reference gets the sizing the configuration states under
``sizing`` (store bits, key bits, deNoise rounds and trigger), so it takes
nothing the program derived.  The harness holds the program's own sizing
against the stated one.
"""

from __future__ import annotations


def windows(config: dict, traffic: dict) -> int:
    """Windows (k-mers) a read has."""
    return int(traffic["read_length"]) - int(config["k"]) + 1


def cli_flags(config: dict, traffic: dict, n_reads: int) -> list:
    n = config.get("trueKmer") or config["genome_length"]
    N = config.get("total_kmers") or n_reads * windows(config, traffic)
    return [*map(str, config["flags"]), "-n", str(n), "-N", str(N)]


def ref_sizing(config: dict) -> dict:
    s = config["sizing"]
    return {"k": int(config["k"]), "key_bits": int(s["key_bits"]),
            "rounds": int(s["deNoise_rounds"]),
            "trigger": int(s["deNoise_trigger"]),
            "end_denoise": "--endDeNoise" in config["flags"],
            "abundance_min": int(config["abundance_min"]),
            "solid_min": int(config["solid_min"]),
            "solid_max": int(config["solid_max"])}


def refuse_other_sizing(config: dict, prog) -> None:
    """Raise when the program's sizing departs from the stated one: such a
    run is of another configuration, and no reading of this one."""
    s = config["sizing"]
    got = {"qb": prog.qb, "key_bits": prog.hb,
           "deNoise_rounds": prog.num_deNoise,
           "deNoise_trigger": prog.ndistinct_for_deNoise}
    apart = {f: (got[f], s[f]) for f in got if got[f] != s[f]}
    if apart:
        raise RuntimeError(f"the program's sizing departs from the "
                           f"configuration's (program, stated): {apart}")


def batch_shape(counter, sizing) -> dict:
    """Rows a batch and bases a row that the program's counting call
    stacks (its own batch geometry, read from the program)."""
    bc = counter.default_batch_cfg(sizing)
    return {"batch_rows": bc.reads_per_batch,
            "row_len": (bc.max_read_len + 7) // 8 * 8}
