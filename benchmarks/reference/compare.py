"""Judging the program's FASTA outputs against the reference's own.

Sequences are compared as canonical strings (the lesser of a sequence and
its reverse complement), so neither side's numbering or orientation
matters.  A link is an unordered pair of unitig ends, each end named by
its unitig's canonical sequence and whether it is that sequence's
beginning or end.
"""

from __future__ import annotations

from collections import Counter

import numpy as np

_COMP = bytes.maketrans(b"ACGT", b"TGCA")
ASCII = np.frombuffer(b"ACGT", np.uint8)


def revcomp(s: bytes) -> bytes:
    return s.translate(_COMP)[::-1]


def canon(s: bytes) -> tuple:
    """(canonical sequence, True when ``s`` is it)."""
    r = revcomp(s)
    return (s, True) if s <= r else (r, False)


def read_fasta(path: str) -> list:
    """[(header fields, sequence bytes)]."""
    out = []
    with open(path, "rb") as f:
        head = None
        for line in f:
            line = line.rstrip(b"\n")
            if line.startswith(b">"):
                head = line[1:].decode().split()
            elif head is not None:
                out.append((head, line))
                head = None
    return out


def _end(seq_canon: tuple, side_end: bool) -> tuple:
    c, fwd = seq_canon
    return (c, side_end if fwd else not side_end)


def _edges(seqs: list, after: list, before: list) -> Counter:
    can = [canon(s) for s in seqs]
    edges = Counter()
    for i, (al, bl) in enumerate(zip(after, before)):
        for side_end, links in ((True, al), (False, bl)):
            a = _end(can[i], side_end)
            for t in links:
                j = abs(t) - 1
                b = _end(can[j], t < 0)
                edges[tuple(sorted((a, b)))] += 1
    return edges


def _apart(a: Counter, b: Counter) -> int:
    return sum(((a - b) + (b - a)).values())


def parse_unitigs(path: str):
    """(sequences, medians, after, before) of a unitig FASTA."""
    seqs, meds, after, before = [], [], [], []
    for head, seq in read_fasta(path):
        med, al, bl = 0, [], []
        for tok in head[1:]:
            if tok.startswith("km:f:"):
                med = int(float(tok[5:]))
            elif tok.startswith("L:"):
                _, d, tid, o = tok.split(":")
                t = (int(tid) + 1) * (1 if o == "+" else -1)
                (al if d == "+" else bl).append(t)
        seqs.append(seq)
        meds.append(med)
        after.append(al)
        before.append(bl)
    return seqs, meds, after, before


def unitigs(path: str, ref: list) -> dict:
    """Unitigs (canonical sequence and median) and links in one graph and
    not the other."""
    seqs, meds, after, before = parse_unitigs(path)
    prog = Counter((canon(s)[0], m) for s, m in zip(seqs, meds))
    rseqs = [ASCII[u["seq"]].tobytes() for u in ref]
    refc = Counter((canon(s)[0], u["med"]) for s, u in zip(rseqs, ref))
    pe = _edges(seqs, after, before)
    re_ = _edges(rseqs, [u["after"] for u in ref], [u["before"] for u in ref])
    return {"unitigs_apart": _apart(prog, refc), "links_apart": _apart(pe, re_)}


def contigs(path: str, ref: list) -> dict:
    """Contigs (canonical sequences) in one set and not the other."""
    prog = Counter(canon(s)[0] for _, s in read_fasta(path))
    refc = Counter(canon(ASCII[c].tobytes())[0] for c, _ in ref)
    return {"contigs_apart": _apart(prog, refc)}
