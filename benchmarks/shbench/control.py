"""The control of the comparison: the plain reference put in the program's
place, computed one step down in precision (its ntHash in 32-bit words
where the configuration states 64), and judged by the same check as the
program.  It has to come out not correct.

Also the readings a limit is set from: the program's numbers over many
seeds at the cell's own size, and the control's, one job each.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from reference import simplify as ref_simplify, spectrum as ref_spectrum, \
    unitigs as ref_unitigs
from . import cellflags

ASCII = np.frombuffer(b"ACGT", np.uint8)


def write_unitigs(path: str, uni: list, k: int) -> None:
    """Unitig FASTA in the program's format (headers with km:f: and L:)."""
    with open(path, "w") as f:
        for i, u in enumerate(uni):
            n = len(u["seq"])
            parts = [f">{i} LN:i:{n} KC:i:{u['med'] * (n - k + 1)} "
                     f"km:f:{u['med']}"]
            for t in u["after"]:
                parts.append(f" L:+:{abs(t) - 1}:{'+' if t > 0 else '-'}")
            for t in u["before"]:
                parts.append(f" L:-:{abs(t) - 1}:{'+' if t > 0 else '-'}")
            f.write("".join(parts) + "\n" + ASCII[u["seq"]].tobytes()
                    .decode() + "\n")


def write_contigs(path: str, ctg: list) -> None:
    with open(path, "w") as f:
        for i, (codes, cov) in enumerate(ctg):
            f.write(f">{i} LN:i:{len(codes)} km:f:{int(cov)}\n"
                    + ASCII[codes].tobytes().decode() + "\n")


def control_outputs(entry, reads: torch.Tensor, outdir: str,
                    bits: int = 32) -> None:
    """Put the reference at ``bits`` in the program's place in ``entry``:
    its spectrum as the program's, its files as the last job's."""
    rs = cellflags.ref_sizing(entry.config)
    keys, counts, total, _ = ref_spectrum.spectrum(reads, rs, bits)
    entry.prog = (keys.cpu().numpy(), counts.cpu().numpy())
    if hasattr(entry, "totals"):
        entry.totals = [(int(counts.sum()), keys.numel())]
    if hasattr(entry, "dirs"):
        uni = ref_unitigs.assemble(reads, rs, keys, counts, bits)
        ctg, _ = ref_simplify.contigs(rs["k"], uni)
        os.makedirs(outdir, exist_ok=True)
        write_unitigs(os.path.join(outdir, "unitigs.fa"), uni, rs["k"])
        write_contigs(os.path.join(outdir, "contigs.fa"), ctg)
        entry.dirs = [outdir]
