"""Minia-style unitig graph simplification -> contigs (pipeline stage 3).

The reference hands its unitig FASTA to a customized Minia v3 for graph
simplification (README.md:133-139; the fork is external to the repo).  This
module brings the simplification in-framework, following Minia v3 /
gatb-core semantics (Chikhi et al.; gatb-core Simplifications):

  * tip clipping     — dead-end unitigs shorter than TIP_TOPO_KMULT * k
                       k-mers are removed unconditionally; up to
                       TIP_RCTC_KMULT * k if their coverage is RCTC-weak
                       relative to sibling branches (factor TIP_RCTC)
  * bubble popping   — two parallel chains with the same endpoints and
                       similar length: the lower-coverage branch is removed
  * EC removal       — short internal connections (< EC_KMULT * k k-mers)
                       whose coverage is EC_RCTC-fold below their
                       neighbours' are removed
  * chain recompaction after every pass (1-1 links merge), iterated until
    a fixpoint (or MAX_ROUNDS)

The graph is tiny relative to the read data (1e5-1e7 unitigs), so these
passes run as host array/graph operations; the heavy lifting (counting,
unitig construction) stays on device.

Graph convention matches the rest of the engine and the reference
(core/unitig_graph.h:25-50): a signed id +-(i+1) enters unitig i forward /
reverse-complemented; side 0 of a unitig is its end (suffix), side 1 its
beginning (prefix, i.e. the RC direction).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..utils import dna
from .contiger import UnitigGraph, Unitig

# Minia v3 simplification defaults (gatb-core Simplifications.cpp)
TIP_TOPO_KMULT = 2.5
TIP_RCTC_KMULT = 10.0
TIP_RCTC = 2.0
BUBBLE_KMULT = 3.0
BUBBLE_KADD = 100
EC_KMULT = 9.0
EC_RCTC = 4.0
MAX_ROUNDS = 10


@dataclass
class SimpleGraph:
    """Mutable doubly-linked unitig graph for simplification passes."""

    k: int
    seqs: list[str]
    cov: list[float]  # mean k-mer abundance per unitig
    # out[i][side] = list of signed ids this side links to.
    # side 0 = forward end (after-links), side 1 = beginning (before-links).
    links: list[list[list[int]]]
    alive: list[bool]

    @classmethod
    def from_unitig_graph(cls, g: UnitigGraph) -> "SimpleGraph":
        n = len(g.unitigs)
        # RCTC coverage = unitig MEAN k-mer abundance (gatb-core
        # Simplifications uses mean, not median).  The in-memory Contiger
        # output carries the mean; graphs reloaded from a reference-format
        # FASTA only have km:f: (median) and fall back to it.
        return cls(
            k=g.k,
            seqs=[u.seq for u in g.unitigs],
            cov=[float(u.mean_abundance) or float(u.median_abundance)
                 for u in g.unitigs],
            links=[[list(g.after[i]), list(g.before[i])] for i in range(n)],
            alive=[True] * n,
        )

    # -- signed-id helpers ---------------------------------------------------
    def _entry_side(self, t: int) -> int:
        """The side of unitig |t|-1 that an edge INTO signed id t attaches to:
        entering forward (+) touches its beginning (side 1); entering
        reverse (-) touches its end (side 0)."""
        return 1 if t > 0 else 0

    def _exit_side_links(self, t: int) -> list[int]:
        """Links continuing a walk through signed id t: forward exits via
        the after list; reverse traversal = RC forward, whose continuations
        are exactly the before list (already signed in RC-forward sense,
        build_graph_worker, contig_assembly.cpp:1052-1063)."""
        i = abs(t) - 1
        return self.links[i][0] if t > 0 else self.links[i][1]

    def nkmers(self, i: int) -> int:
        return len(self.seqs[i]) - self.k + 1

    def degree(self, i: int, side: int) -> int:
        return len(self.links[i][side])

    def remove(self, i: int) -> None:
        """Delete unitig i and all links referencing it."""
        self.alive[i] = False
        for t in self.links[i][0] + self.links[i][1]:
            j = abs(t) - 1
            if not self.alive[j]:
                continue
            for side in (0, 1):
                self.links[j][side] = [
                    x for x in self.links[j][side] if abs(x) - 1 != i
                ]
        self.links[i] = [[], []]

    # -- passes --------------------------------------------------------------
    def clip_tips(self) -> int:
        """Remove dead-end tips (Minia tip clipping)."""
        removed = 0
        topo_max = TIP_TOPO_KMULT * self.k
        rctc_max = TIP_RCTC_KMULT * self.k
        for i in range(len(self.seqs)):
            if not self.alive[i]:
                continue
            d0, d1 = self.degree(i, 0), self.degree(i, 1)
            if d0 == 0 and d1 == 0:
                # isolated short unitigs are doubly-dead-end tips: typically
                # repeated-error k-mers (count >= 2 survives deNoise) whose
                # single-count neighbors were purged, leaving orphan nodes.
                # Only the topological rule can apply — there is no junction
                # for the RCTC comparison.
                if self.nkmers(i) <= topo_max:
                    self.remove(i)
                    removed += 1
                continue
            if d0 > 0 and d1 > 0:
                continue  # internal node, not a tip
            nk = self.nkmers(i)
            if nk > rctc_max:
                continue
            anchor_side = 0 if d0 > 0 else 1
            # sibling branches at the junction: other edges entering the
            # same side of the anchor node(s)
            connected = self.links[i][anchor_side]
            is_simple = nk <= topo_max
            if not is_simple:
                # RCTC: keep the tip if its coverage holds up against the
                # strongest sibling path at the junction
                sib_cov = 0.0
                for t in connected:
                    j = abs(t) - 1
                    side = self._entry_side(t)
                    for s in self.links[j][side]:
                        m = abs(s) - 1
                        if m != i and self.alive[m]:
                            sib_cov = max(sib_cov, self.cov[m])
                if not (self.cov[i] * TIP_RCTC < sib_cov):
                    continue
            # never clip if it would disconnect: junction must keep >= 1
            # other branch, OR the tip is trivially short
            has_sibling = False
            for t in connected:
                j = abs(t) - 1
                side = self._entry_side(t)
                if any(abs(s) - 1 != i for s in self.links[j][side]):
                    has_sibling = True
            if not has_sibling and not is_simple:
                continue
            self.remove(i)
            removed += 1
        return removed

    def pop_bubbles(self) -> int:
        """Pop simple 2-branch bubbles: u ->(a|b)-> w, keep higher coverage."""
        removed = 0
        max_len = BUBBLE_KMULT * self.k + BUBBLE_KADD
        for i in range(len(self.seqs)):
            if not self.alive[i]:
                continue
            for side in (0, 1):
                outs = self.links[i][side]
                if len(outs) < 2:
                    continue
                # candidate branches: simple unitigs (1 in, 1 out) whose far
                # end reconverges on the same target
                branch = {}
                for t in outs:
                    j = abs(t) - 1
                    if not self.alive[j] or j == i:
                        continue
                    if self.degree(j, 0) != 1 or self.degree(j, 1) != 1:
                        continue
                    if len(self.seqs[j]) > max_len:
                        continue
                    exits = self._exit_side_links(t)
                    if len(exits) != 1:
                        continue
                    dest = exits[0]
                    branch.setdefault(dest, []).append(j)
                for dest, js in branch.items():
                    if len(js) < 2:
                        continue
                    js = sorted(set(js), key=lambda j: (-self.cov[j], j))
                    for j in js[1:]:
                        if self.alive[j]:
                            self.remove(j)
                            removed += 1
        return removed

    def remove_erroneous_connections(self) -> int:
        """Drop short, weakly covered internal unitigs (Minia EC removal)."""
        removed = 0
        max_len = EC_KMULT * self.k
        for i in range(len(self.seqs)):
            if not self.alive[i]:
                continue
            if self.nkmers(i) > max_len:
                continue
            d0, d1 = self.degree(i, 0), self.degree(i, 1)
            if d0 == 0 or d1 == 0:
                continue  # tips are handled by clip_tips
            neigh_cov = [
                self.cov[abs(t) - 1]
                for t in self.links[i][0] + self.links[i][1]
                if self.alive[abs(t) - 1] and abs(t) - 1 != i
            ]
            if not neigh_cov:
                continue
            if self.cov[i] * EC_RCTC < min(neigh_cov):
                self.remove(i)
                removed += 1
        return removed

    def compact(self) -> int:
        """Merge 1-1 linked chains into single unitigs."""
        merged = 0
        n = len(self.seqs)
        for i in range(n):
            if not self.alive[i]:
                continue
            # extend forward from i's end while the junction is 1-1
            while True:
                outs = self.links[i][0]
                if len(outs) != 1:
                    break
                t = outs[0]
                j = abs(t) - 1
                if j == i or not self.alive[j]:
                    break
                enter = self._entry_side(t)
                if len(self.links[j][enter]) != 1:
                    break
                # splice j into i
                jseq = self.seqs[j] if t > 0 else dna.revcomp(self.seqs[j])
                nk_i, nk_j = self.nkmers(i), self.nkmers(j)
                self.seqs[i] = self.seqs[i] + jseq[self.k - 1 :]
                self.cov[i] = (self.cov[i] * nk_i + self.cov[j] * nk_j) / (
                    nk_i + nk_j
                )
                far = self._exit_side_links(t)
                self.links[i][0] = list(far)
                # rewrite links pointing at j's far side to point at i
                for s in far:
                    m = abs(s) - 1
                    side = self._entry_side(s)
                    self.links[m][side] = [
                        (i + 1) if abs(x) - 1 == j and ((x > 0) == (t > 0))
                        else (-(i + 1)) if abs(x) - 1 == j
                        else x
                        for x in self.links[m][side]
                    ]
                self.alive[j] = False
                self.links[j] = [[], []]
                merged += 1
        return merged

    def simplify(self, max_rounds: int = MAX_ROUNDS) -> dict:
        """Iterate all passes to a fixpoint; returns removal stats."""
        stats = {"tips": 0, "bubbles": 0, "ec": 0, "rounds": 0}
        for _ in range(max_rounds):
            t = self.clip_tips()
            self.compact()
            b = self.pop_bubbles()
            self.compact()
            e = self.remove_erroneous_connections()
            self.compact()
            stats["tips"] += t
            stats["bubbles"] += b
            stats["ec"] += e
            stats["rounds"] += 1
            if t + b + e == 0:
                break
        return stats

    def contigs(self) -> list[Unitig]:
        out = []
        for i in range(len(self.seqs)):
            if self.alive[i]:
                out.append(Unitig(seq=self.seqs[i],
                                  median_abundance=int(self.cov[i])))
        return out


def load_unitig_fasta(path: str, k: int) -> UnitigGraph:
    """Parse a unitig FASTA with km:f:/L: annotations (reference
    load_unitig_graph, core/unitig_graph.cpp:29-110; same convention as
    UnitigGraph.write_fasta)."""
    g = UnitigGraph(k=k)
    with open(path) as f:
        header = None
        for line in f:
            line = line.rstrip()
            if not line:
                continue
            if line.startswith(">"):
                header = line
            else:
                fields = header.split()
                med = 0
                after: list[int] = []
                before: list[int] = []
                for tok in fields[1:]:
                    if tok.startswith("km:f:"):
                        med = int(float(tok[5:]))
                    elif tok.startswith("L:"):
                        _, d, tid, orient = tok.split(":")
                        signed = (int(tid) + 1) * (1 if orient == "+" else -1)
                        (after if d == "+" else before).append(signed)
                g.unitigs.append(Unitig(seq=line, median_abundance=med))
                g.after.append(after)
                g.before.append(before)
    return g


def simplify_to_contigs(g: UnitigGraph, max_rounds: int = MAX_ROUNDS):
    sg = SimpleGraph.from_unitig_graph(g)
    stats = sg.simplify(max_rounds)
    contigs = sg.contigs()
    return contigs, stats


def write_contigs(path: str, contigs: list[Unitig], k: int) -> None:
    """Minia-style contig FASTA: >id LN:i:len km:f:cov."""
    with open(path, "w") as f:
        for i, c in enumerate(contigs):
            f.write(f">{i} LN:i:{len(c.seq)} km:f:{c.median_abundance}\n")
            f.write(c.seq + "\n")


def contig_stats(contigs: list[Unitig], genome_size: int | None = None):
    """Assembly summary: N50 etc. (reference contig_summary,
    base/Utility.h:923-1001)."""
    lens = sorted((len(c.seq) for c in contigs), reverse=True)
    total = sum(lens)
    out = {
        "n_contigs": len(lens),
        "total_len": total,
        "max_len": lens[0] if lens else 0,
    }
    acc = 0
    for L in lens:
        acc += L
        if acc * 2 >= total:
            out["N50"] = L
            break
    else:
        out["N50"] = 0
    if genome_size:
        acc = 0
        ng50 = 0
        for L in lens:
            acc += L
            if acc * 2 >= genome_size:
                ng50 = L
                break
        out["NG50"] = ng50
    return out
