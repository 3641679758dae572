"""Entry ``count``: one job counts the reads into the spectrum, the call
that ``cli.cqf_denoise`` and ``cli.pipeline`` make
(``models.counter.build_spectrum_from_files``), sized by
``cli.cqf_denoise.counter_sizing`` from the configuration's flags.  The
``.ser`` writer is not in the job.

Judged after the window: each job's k-mers and distinct keys after the
end sweep, and the last job's whole spectrum (keys and counts), against
the plain reference's; exact.  A program whose sizing departs from the
configuration's stated sizing runs another configuration: the check
refuses it outright.
"""

from __future__ import annotations

import torch

from shbench import cellflags
from reference import spectrum as ref_spectrum

LIMITS = {"spectrum_keys_apart": 0, "spectrum_counts_apart": 0,
          "job_totals_apart": 0}


class Entry:
    def __init__(self, ctx: dict):
        from sh_assembly_tpu_torch.cli import cqf_denoise
        from sh_assembly_tpu_torch.io import fastq
        from sh_assembly_tpu_torch.models import counter
        from sh_assembly_tpu_torch.utils import profiling

        self.ctx = ctx
        self.counter, self.fastq, self.profiling = counter, fastq, profiling
        self.config, self.traffic = ctx["config"], ctx["traffic"]
        flags = cellflags.cli_flags(self.config, self.traffic, ctx["n_reads"])
        self.args_of = lambda lst: cqf_denoise.make_parser().parse_args(
            [*flags, "-i", lst])
        self.sizing_of = cqf_denoise.counter_sizing
        self.spec = None
        self.sizing = None
        self.totals = []  # (kmers, distinct) a job
        self.batches = []

    def job(self, list_path: str) -> dict:
        self.spec = None  # the last job's store is freed before this one
        args = self.args_of(list_path)
        self.sizing = self.sizing_of(args)
        self.profiling.reset()
        spec, stats = self.counter.build_spectrum_from_files(
            self.fastq.read_file_list(list_path), self.sizing,
            fmode=args.format, n_threads=args.threads,
            device=self.ctx["device"])
        self.spec = spec
        return {"kmers_in": stats.kmers, "distinct": stats.distinct,
                "batches": stats.batches,
                **cellflags.batch_shape(self.counter, self.sizing)}

    def collect(self, jobs: list) -> None:
        """Take the program's outputs to the host and free its state."""
        from sh_assembly_tpu_torch.ops import spectrum as sp

        self.prog = sp.to_host(self.spec, self.sizing.hb)[:2]
        self.totals = [(j["kmers_in"], j["distinct"]) for j in jobs]
        self.spec = None

    def judge(self, reads: torch.Tensor, bits: int = 64) -> tuple:
        """(numbers compared, jobs whose own answer is wrong)."""
        cellflags.refuse_other_sizing(self.config, self.sizing)
        rs = cellflags.ref_sizing(self.config)
        keys, counts, _, _ = ref_spectrum.spectrum(reads, rs, bits)
        cmp = ref_spectrum.compare(*self.prog, keys, counts)
        want = (int(counts.sum()), keys.numel())
        bad = sum(t != want for t in self.totals)
        nums = {"spectrum_keys_apart": cmp["keys_apart"],
                "spectrum_counts_apart": cmp["counts_apart"],
                "job_totals_apart": bad}
        return nums, bad
