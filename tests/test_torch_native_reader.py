"""The port's native reader (sh_assembly_tpu_torch/cpp/fastq_reader.cpp)
against the JAX package's native reader (cpp/fastq_reader.cpp), batch by
batch and bitwise, on the packed and the codes path.

The port's reader cuts one file into record-aligned parts that its workers
decode in parallel; its batches must be the reference's, in the reference's
order.  The reference reads with one thread, so its order is the file's.
Small parts (``_part_bytes``) put many parts, and part edges inside every
kind of line, into files of a few MB.
"""

from __future__ import annotations

import bz2
import gzip
import os

import numpy as np
import pytest

from sh_assembly_tpu.io import native as jnative
from sh_assembly_tpu_torch.io import native

K, B, L = 21, 512, 96
PART = 1 << 16  # 64 KB parts: a few MB make dozens of parts
FIELDS = ("codes", "packed", "nmask", "lengths", "seed_col")


def _read(rng, n: int) -> str:
    return "".join(rng.choice(list("ACGT"), n))


def _reads(rng, n_reads: int) -> list[str]:
    """Reads of 0-400 bases: shorter than k, one row, tiled over several
    rows; N runs before and after offset k and inside the middle k-mer;
    lower case; a few whole-N reads."""
    out = []
    for i in range(n_reads):
        n = int(rng.choice([0, 5, 20, 21, 60, 96, 150, 250, 400],
                           p=[.01, .04, .03, .02, .15, .1, .4, .15, .1]))
        r = list(_read(rng, n))
        if n and i % 3 == 0:
            for _ in range(int(rng.integers(1, 4))):
                at = int(rng.integers(0, n))
                run = int(rng.integers(1, 6))
                r[at:at + run] = "N" * len(r[at:at + run])
        if n and i % 11 == 0:
            r = [c.lower() for c in r]
        if n and i % 97 == 0:
            r = ["N"] * n
        out.append("".join(r))
    return out


def _fastq(reads: list[str], eol: str = "\n") -> bytes:
    lines = []
    for i, r in enumerate(reads):
        # qualities that start with '@' and '+': records are line counts
        qual = ("@" if i % 5 == 0 else "+" if i % 7 == 0 else "I") \
            + "I" * max(len(r) - 1, 0)
        lines += [f"@r{i} x", r, "+", qual[:len(r)]]
    return (eol.join(lines) + eol).encode()


def _fasta(reads: list[str]) -> bytes:
    """Multi-line records wrapped at 60 or 70, blank lines, a header with
    no sequence."""
    out = []
    for i, r in enumerate(reads):
        out.append(f">s{i} desc")
        w = 60 if i % 2 else 70
        out += [r[j:j + w] for j in range(0, len(r), w)]
        if i % 13 == 0:
            out.append("")
    out.append(">empty")
    return ("\n".join(out) + "\n").encode()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Every input, written once: name -> path."""
    if not native.available() or not jnative.available():
        pytest.skip("no C++ toolchain for the native readers")
    d = tmp_path_factory.mktemp("reads")
    rng = np.random.default_rng(21)
    reads = _reads(rng, 12000)
    raw = _fastq(reads)
    small = _reads(rng, 60)
    crlf = _fastq([r.lower() if i % 2 else r
                   for i, r in enumerate(reads[:6000])], "\r\n")
    blobs = {
        "plain.fastq": raw,
        "fasta.fa": _fasta(reads[:4000]),
        "crlf_lower.fastq": crlf,
        "no_final_newline.fastq": raw.rstrip(b"\n"),
        "truncated_record.fastq": raw + b"@cut\nACGTACGTACGTACGTACGTACGTA\n",
        "empty.fastq": b"",
        "small.fastq": _fastq(small),
        "small.fa": _fasta(small),
    }
    paths = {}
    for name, blob in blobs.items():
        paths[name] = str(d / name)
        with open(paths[name], "wb") as f:
            f.write(blob)
    paths["gz.fastq.gz"] = str(d / "gz.fastq.gz")
    with gzip.open(paths["gz.fastq.gz"], "wb", compresslevel=1) as f:
        f.write(raw)
    # two bzip2 streams, the second starting inside a record
    paths["bz2.fastq.bz2"] = str(d / "bz2.fastq.bz2")
    with open(paths["bz2.fastq.bz2"], "wb") as f:
        f.write(bz2.compress(raw[:len(raw) // 2 + 7], 1))
        f.write(bz2.compress(raw[len(raw) // 2 + 7:], 1))
    return paths


def _stream(mod, packed: bool, paths: list[str], **kw) -> list:
    fn = mod.packed_batches_from_files if packed else mod.batches_from_files
    return list(fn(paths, K, "auto", B, L, **kw))


def _reference(paths: list[str], packed: bool) -> list:
    return _stream(jnative, packed, paths, n_threads=1)


def _assert_same(got: list, want: list) -> None:
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.n_rows == w.n_rows, f"batch {i}"
        for f in FIELDS:
            if hasattr(w, f):
                np.testing.assert_array_equal(getattr(g, f), getattr(w, f),
                                              err_msg=f"batch {i}, {f}")


def _rows(batches: list, packed: bool) -> list[tuple]:
    """Each row's bytes, in stream order."""
    out = []
    for b in batches:
        arrays = [b.packed, b.nmask] if packed else [b.codes]
        for r in range(b.n_rows):
            out.append((*(bytes(a[r]) for a in arrays), int(b.lengths[r]),
                        int(b.seed_col[r])))
    return out


CASES = ["plain.fastq", "gz.fastq.gz", "bz2.fastq.bz2", "fasta.fa",
         "crlf_lower.fastq", "no_final_newline.fastq",
         "truncated_record.fastq", "empty.fastq"]


@pytest.mark.parametrize("n_threads", [1, 8])
@pytest.mark.parametrize("packed", [False, True], ids=["codes", "packed"])
@pytest.mark.parametrize("case", CASES)
def test_batches_match_the_reference(files, case, packed, n_threads):
    want = _reference([files[case]], packed)
    got = _stream(native, packed, [files[case]], n_threads=n_threads,
                  _part_bytes=PART)
    _assert_same(got, want)
    if case != "empty.fastq":
        assert sum(b.n_rows for b in want) > 1000


@pytest.mark.parametrize("part_bytes", [1, 7, 61, 1000])
@pytest.mark.parametrize("case", ["small.fastq", "small.fa"])
def test_part_edges_inside_every_line(files, case, part_bytes):
    """Parts smaller than a record: every part edge falls inside a line,
    and the reader reads on until a whole record is in the part."""
    for packed in (False, True):
        want = _reference([files[case]], packed)
        got = _stream(native, packed, [files[case]], n_threads=8,
                      _part_bytes=part_bytes)
        _assert_same(got, want)


@pytest.mark.parametrize("n_threads", [1, 8])
@pytest.mark.parametrize("packed", [False, True], ids=["codes", "packed"])
def test_several_files_in_list_order(files, packed, n_threads):
    """One file after another: the concatenation of the per-file reference
    streams, batched anew (a segment's rows may straddle files' batches)."""
    names = ["small.fastq", "gz.fastq.gz", "empty.fastq", "fasta.fa",
             "bz2.fastq.bz2"]
    paths = [files[n] for n in names]
    want = [row for p in paths for row in _rows(_reference([p], packed),
                                                packed)]
    got = _stream(native, packed, paths, n_threads=n_threads,
                  _part_bytes=PART)
    assert _rows(got, packed) == want
    assert all(b.n_rows == B for b in got[:-1])


@pytest.mark.parametrize("packed", [False, True], ids=["codes", "packed"])
def test_a_missing_file_raises(files, tmp_path, packed):
    for paths in ([str(tmp_path / "nope.fastq")],
                  [files["small.fastq"], str(tmp_path / "nope.fastq")]):
        with pytest.raises(IOError):
            _stream(native, packed, paths, n_threads=8)


@pytest.mark.parametrize("packed", [False, True], ids=["codes", "packed"])
def test_reports_parts_and_workers(files, packed):
    """A plain file of S bytes read in parts of P bytes: ceil(S / P) parts
    (the last one short), decoded on more than one worker."""
    path = files["plain.fastq"]
    stats = native.ReaderStats()
    _stream(native, packed, [path], n_threads=8, stats=stats,
            _part_bytes=PART)
    assert stats.parts == -(-os.path.getsize(path) // PART)
    assert stats.workers >= 2
    assert stats.wait_s >= 0.0
    one = native.ReaderStats()
    _stream(native, packed, [path], n_threads=8, stats=one)
    assert (one.parts, one.workers) == (1, 1)  # under 8 MB: one part
