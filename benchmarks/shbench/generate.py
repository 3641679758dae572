"""Genome and reads of a cell, made from the seed in vectorised NumPy.

One general generator reads every traffic mix: a mix is a data file of
parameters (``traffic/<name>.json``), never code.  The genome is uniform
random sequence of the configuration's length; reads are uniform start
positions on either strand with independent substitutions.  The same seed
gives the same genome and reads, byte for byte.
"""

from __future__ import annotations

import os

import numpy as np

ASCII = np.frombuffer(b"ACGT", np.uint8)
CHUNK_READS = 1 << 18


def n_reads(config: dict, traffic: dict) -> int:
    """Reads a job: ``reads`` if the mix fixes them, else depth x genome /
    read length, rounded."""
    if traffic.get("reads"):
        return int(traffic["reads"])
    return int(round(traffic["depth"] * config["genome_length"]
                     / traffic["read_length"]))


def make_reads(seed: int, config: dict, traffic: dict) -> np.ndarray:
    """uint8 base codes (A=0, C=1, G=2, T=3), one row a read."""
    rng = np.random.default_rng([int(seed), 0x5EED])
    G = int(config["genome_length"])
    L = int(traffic["read_length"])
    n = n_reads(config, traffic)
    genome = rng.integers(0, 4, size=G, dtype=np.uint8)
    starts = rng.integers(0, G - L + 1, size=n)
    reverse = rng.random(n) < 0.5 if traffic.get("both_strands", True) \
        else np.zeros(n, bool)
    reads = np.empty((n, L), np.uint8)
    cols = np.arange(L)
    for a in range(0, n, CHUNK_READS):
        b = min(a + CHUNK_READS, n)
        rows = genome[starts[a:b, None] + cols]
        rv = reverse[a:b]
        rows[rv] = 3 - rows[rv, ::-1]
        reads[a:b] = rows
    # substitutions: each base independently at sub_rate, to one of the
    # three other bases
    rate = float(traffic.get("sub_rate", 0.0))
    if rate > 0:
        n_err = rng.binomial(n * L, rate)
        pos = np.unique(rng.integers(0, n * L, size=n_err))
        shift = rng.integers(1, 4, size=len(pos), dtype=np.uint8)
        flat = reads.reshape(-1)
        flat[pos] = (flat[pos] + shift) % 4
    return reads


def write_fastq(path: str, reads: np.ndarray) -> None:
    """Four-line FASTQ records with fixed-width names, written in bulk."""
    n, L = reads.shape
    width = max(len(str(max(n - 1, 0))), 1)
    head = 1 + width + 1  # "@" digits "\n"
    rec = head + L + 1 + 2 + L + 1
    with open(path, "wb") as f:
        for a in range(0, n, CHUNK_READS):
            b = min(a + CHUNK_READS, n)
            m = b - a
            buf = np.empty((m, rec), np.uint8)
            buf[:, 0] = ord("@")
            ids = np.arange(a, b, dtype=np.int64)
            for d in range(width):
                buf[:, width - d] = ord("0") + (ids // 10 ** d) % 10
            buf[:, head - 1] = ord("\n")
            buf[:, head:head + L] = ASCII[reads[a:b]]
            o = head + L
            buf[:, o] = ord("\n")
            buf[:, o + 1] = ord("+")
            buf[:, o + 2] = ord("\n")
            buf[:, o + 3:o + 3 + L] = ord("I")
            buf[:, rec - 1] = ord("\n")
            f.write(buf.tobytes())


def write_job_files(workdir: str, name: str, reads: np.ndarray) -> str:
    """The FASTQ and its read-file list under ``workdir``; returns the
    list's path."""
    fq = os.path.join(workdir, f"{name}.fastq")
    write_fastq(fq, reads)
    lst = os.path.join(workdir, f"{name}.txt")
    with open(lst, "w") as f:
        f.write(fq + "\n")
    return lst
