"""The comparison fails its control and the faults a cell can have.

The control is the plain reference in the program's place with its ntHash
in 32-bit words.  The faults are planted in the program underneath a run
that skips the look for a chip: a counting step that returns its state
unchanged, half of each batch's reads left out, an answer altered where it
is produced.  (The exchange between chips: no cell spans chips.)
"""

from __future__ import annotations

import pytest

import readings
from shbench import runner


@pytest.mark.parametrize("cell", ["tiny.pipeline", "tiny.count"])
def test_control_fails_and_program_passes(bench_copy, cell):
    root, here = bench_copy
    r = readings.readings(cell, 77, "cpu", True, root=root, here=here)
    assert all(v == 0 for v in r["program"].values()), r["program"]
    assert r["control"]["spectrum_keys_apart"] > 0
    if cell == "tiny.pipeline":
        assert r["control"]["unitigs_apart"] > 0


def _fault(monkeypatch, kind):
    from sh_assembly_tpu_torch.models import contiger, counter, \
        simplify_arrays
    from sh_assembly_tpu_torch.ops import spectrum as sp

    if kind == "state_unchanged":
        monkeypatch.setattr(counter, "append_scan_packed",
                            lambda spec, *a, **kw: spec)
    elif kind == "half_batch":
        real = counter.build_spectrum

        def half(batches, *a, **kw):
            def cut(it):
                for b in it:
                    keep = b.n_rows // 2
                    b.lengths[keep:] = 0
                    yield b
            return real(cut(batches), *a, **kw)
        monkeypatch.setattr(counter, "build_spectrum", half)
    elif kind == "count_altered":
        real = sp.sweep

        def bump(spec, key_bits):
            out = real(spec, key_bits)
            out.store[0] += 1  # one more occurrence of the least key
            return out
        monkeypatch.setattr(sp, "sweep", bump)
    elif kind == "unitig_altered":
        real = contiger.ArrayUnitigs.write_fasta

        def flip(self, path):
            self.seq_codes[len(self.seq_codes) // 2] ^= 1
            return real(self, path)
        monkeypatch.setattr(contiger.ArrayUnitigs, "write_fasta", flip)
    elif kind == "contig_altered":
        real = simplify_arrays.write_contigs_arrays

        def flip(path, codes, offs, cov):
            codes = codes.copy()
            codes[len(codes) // 2] ^= 1
            return real(path, codes, offs, cov)
        monkeypatch.setattr(simplify_arrays, "write_contigs_arrays", flip)


@pytest.mark.parametrize("cell,kind", [
    ("tiny.count", "state_unchanged"), ("tiny.count", "half_batch"),
    ("tiny.count", "count_altered"),
    ("tiny.pipeline", "state_unchanged"), ("tiny.pipeline", "half_batch"),
    ("tiny.pipeline", "count_altered"), ("tiny.pipeline", "unitig_altered"),
    ("tiny.pipeline", "contig_altered")])
def test_fault_makes_run_incorrect(bench_copy, monkeypatch, cell, kind):
    root, here = bench_copy
    _fault(monkeypatch, kind)
    res = runner.run(cell, 4242, 0, False, "cpu", root=root, here=here)
    assert not res["correct"], res["checks"]
