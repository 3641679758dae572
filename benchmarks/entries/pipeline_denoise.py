"""Entry ``pipeline_denoise``: the ``pipeline`` entry's job,
``cli.pipeline.main(argv)``, at a sizing whose deNoise rounds fire in
mid-stream.

Which keys a sweep drops depends on when it fires, so the spectrum is
judged against ``reference/denoise.py``, which models the counting
stage's merge cadence from the geometry the configuration states
(``geometry``: reads a batch, bases a row, buffer slots).  Besides the
``pipeline`` entry's five numbers, each job's own counters are judged:
the rounds fired and the keys they swept (``BuildStats.rounds`` and
``swept``).  Exact.  A program whose sizing or cadence geometry departs
from the stated one runs another configuration, and one that counts no
rounds cannot be judged: the check refuses both outright.
"""

from __future__ import annotations

import os

import torch

from shbench import cellflags, control, registry
from reference import compare, denoise as ref_denoise, \
    simplify as ref_simplify, spectrum as ref_spectrum, unitigs as ref_unitigs

_pipeline = registry.load_module(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "pipeline.py"),
    "shbench_entry_pipeline_base")

LIMITS = {**_pipeline.LIMITS, "rounds_apart": 0, "swept_apart": 0}
COUNTERS = ("rounds", "swept", "early_merges")
GEOMETRY = ("batch_rows", "row_len", "buffer_slots")


class Entry(_pipeline.Entry):
    def __init__(self, ctx: dict):
        from sh_assembly_tpu_torch.models import counter

        missing = [c for c in COUNTERS
                   if c not in getattr(counter.BuildStats,
                                       "__dataclass_fields__", {})]
        if missing:
            raise RuntimeError(f"the program counts no {missing} "
                               f"(models/counter.BuildStats): this cell "
                               f"judges them")
        super().__init__(ctx)
        self.jobs: list = []

    def job(self, list_path: str) -> dict:
        out = super().job(list_path)
        st = self.seen["stats"]
        return {**out, **{c: getattr(st, c) for c in COUNTERS},
                "buffer_slots": self.seen["spec"].buf_capacity}

    def collect(self, jobs: list) -> None:
        super().collect(jobs)
        self.jobs = jobs

    def judge(self, reads: torch.Tensor, bits: int = 64) -> tuple:
        """(numbers compared, jobs whose own answer is wrong)."""
        cellflags.refuse_other_sizing(self.config, self.sizing)
        refuse_other_geometry(self.config, self.jobs)
        rs = cellflags.ref_sizing(self.config)
        ref = ref_denoise.spectrum(reads, rs, self.config["geometry"], bits)
        cmp = ref_spectrum.compare(*self.prog, ref.keys, ref.counts)
        self.prog = None
        uni = ref_unitigs.assemble(reads, rs, ref.keys, ref.counts, bits)
        ctg, _ = ref_simplify.contigs(rs["k"], uni)
        per_job = []
        for d, j in zip(self.dirs, self.jobs):
            per_job.append({
                **compare.unitigs(os.path.join(d, "unitigs.fa"), uni),
                **compare.contigs(os.path.join(d, "contigs.fa"), ctg),
                "rounds_apart": abs(j["rounds"] - ref.rounds),
                "swept_apart": abs(j["swept"] - ref.swept)})
        nums = {"spectrum_keys_apart": cmp["keys_apart"],
                "spectrum_counts_apart": cmp["counts_apart"],
                **{k: max(j[k] for j in per_job) for k in per_job[0]}}
        bad = sum(1 for j in per_job if any(j.values()))
        return nums, bad


def refuse_other_geometry(config: dict, jobs: list) -> None:
    """Raise when a job's cadence geometry departs from the stated one: the
    reference's sweeps would fire at other times than the program's."""
    want = config["geometry"]
    for j in jobs:
        apart = {g: (j[g], want[g]) for g in GEOMETRY if j[g] != want[g]}
        if apart:
            raise RuntimeError(f"the program's cadence geometry departs from "
                               f"the configuration's (program, stated): "
                               f"{apart}")


def control_outputs(entry: Entry, reads: torch.Tensor, outdir: str,
                    bits: int = 64, near_trigger: bool = True) -> None:
    """Put the reference in the program's place in ``entry``: with its hash
    in ``bits``-bit words (the hash control, at 32) or with its
    near-trigger rule off (the cadence control: sweeps at other times)."""
    rs = cellflags.ref_sizing(entry.config)
    ref = ref_denoise.spectrum(reads, rs, entry.config["geometry"], bits,
                               near_trigger)
    entry.prog = (ref.keys.cpu().numpy(), ref.counts.cpu().numpy())
    uni = ref_unitigs.assemble(reads, rs, ref.keys, ref.counts, bits)
    ctg, _ = ref_simplify.contigs(rs["k"], uni)
    os.makedirs(outdir, exist_ok=True)
    control.write_unitigs(os.path.join(outdir, "unitigs.fa"), uni, rs["k"])
    control.write_contigs(os.path.join(outdir, "contigs.fa"), ctg)
    entry.dirs = [outdir]
    entry.jobs = [{**entry.jobs[-1], "rounds": ref.rounds,
                   "swept": ref.swept, "early_merges": ref.early_merges}]
