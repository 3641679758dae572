"""Entry ``pipeline``: one job is ``cli.pipeline.main(argv)``, what a user
runs: reads -> counting -> Contiger -> ``unitigs.fa`` -> simplification ->
``contigs.fa``, each job's files in a directory of its own.

Judged after the window, against the plain reference run on the same
reads: the last job's spectrum (kept on the device from the counting call
until the window closes, never copied inside it), and every job's
``unitigs.fa`` (unitigs with their medians, and links) and ``contigs.fa``,
each number the worst job's.  Exact.  A program whose sizing departs from
the configuration's stated sizing runs another configuration: the check
refuses it outright.
"""

from __future__ import annotations

import os

import torch

from shbench import cellflags
from reference import compare, simplify as ref_simplify, \
    spectrum as ref_spectrum, unitigs as ref_unitigs

LIMITS = {"spectrum_keys_apart": 0, "spectrum_counts_apart": 0,
          "unitigs_apart": 0, "links_apart": 0, "contigs_apart": 0}


class Entry:
    def __init__(self, ctx: dict):
        from sh_assembly_tpu_torch.cli import pipeline
        from sh_assembly_tpu_torch.models import counter

        self.ctx = ctx
        self.config, self.traffic = ctx["config"], ctx["traffic"]
        self.flags = cellflags.cli_flags(self.config, self.traffic,
                                         ctx["n_reads"])
        self.main = pipeline.main
        self.counter = counter
        self.seen: dict = {}
        self.dirs = []
        real = getattr(counter.build_spectrum_from_files, "real",
                       counter.build_spectrum_from_files)

        def spy(files, sizing, *a, **kw):
            # hands the program's own result on untouched; keeps a handle
            # to it (never a copy) for the check after the window
            self.seen = {}
            spec, stats = real(files, sizing, *a, **kw)
            self.seen = {"spec": spec, "stats": stats, "sizing": sizing}
            return spec, stats

        spy.real = real
        counter.build_spectrum_from_files = spy

    def reset(self) -> None:
        """Forget the warm-up job's files."""
        self.dirs = []

    def job(self, list_path: str) -> dict:
        self.seen = {}  # the last job's store is freed before this one
        out = os.path.join(self.ctx["workdir"], f"job{len(self.dirs)}")
        os.makedirs(out, exist_ok=True)
        self.dirs.append(out)
        rc = self.main([*self.flags, "-i", list_path,
                        "-o", os.path.join(out, "contigs.fa"),
                        "--unitigs", os.path.join(out, "unitigs.fa"),
                        "--device", str(self.ctx["device"])])
        if rc != 0:
            raise RuntimeError(f"cli.pipeline returned {rc}")
        st, sz = self.seen["stats"], self.seen["sizing"]
        return {"kmers_in": st.kmers, "distinct": st.distinct,
                "batches": st.batches,
                **cellflags.batch_shape(self.counter, sz)}

    def collect(self, jobs: list) -> None:
        from sh_assembly_tpu_torch.ops import spectrum as sp

        self.sizing = self.seen["sizing"]
        self.prog = sp.to_host(self.seen["spec"], self.sizing.hb)[:2]
        self.seen = {}

    def judge(self, reads: torch.Tensor, bits: int = 64) -> tuple:
        """(numbers compared, jobs whose own answer is wrong)."""
        cellflags.refuse_other_sizing(self.config, self.sizing)
        rs = cellflags.ref_sizing(self.config)
        keys, counts, _, _ = ref_spectrum.spectrum(reads, rs, bits)
        cmp = ref_spectrum.compare(*self.prog, keys, counts)
        self.prog = None
        uni = ref_unitigs.assemble(reads, rs, keys, counts, bits)
        del keys, counts
        ctg, _ = ref_simplify.contigs(rs["k"], uni)
        per_job = []
        for d in self.dirs:
            per_job.append({
                **compare.unitigs(os.path.join(d, "unitigs.fa"), uni),
                **compare.contigs(os.path.join(d, "contigs.fa"), ctg)})
        nums = {"spectrum_keys_apart": cmp["keys_apart"],
                "spectrum_counts_apart": cmp["counts_apart"],
                **{k: max(j[k] for j in per_job) for k in per_job[0]}}
        bad = sum(1 for j in per_job if any(j.values()))
        return nums, bad
