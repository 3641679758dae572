"""The plain reference's graph simplification: unitigs -> contigs, in plain
Python loops over the unitig graph.

The rules are Minia v3's (gatb-core Simplifications.cpp constants), each
pass judged against the graph as the pass found it and applied at once:

  * tips: a unitig with a dead end and at most 10k k-mers goes if it has
    at most 2.5k k-mers, or if twice its mean coverage is below the best
    other branch at its junction and such a branch exists;
  * bubbles: of the simple branches (one link each side, at most 3k + 100
    bases) leaving one side of a unitig for the same target, all but the
    best covered (the lower id on a tie) go;
  * erroneous connections: an internal unitig of at most 9k k-mers goes if
    four times its mean coverage is below every live neighbour's;
  * after each pass, 1-1 links merge (a cycle cut at its least oriented
    index; the kept copy of a chain and its mirror starts at the lower
    oriented index); mean coverage is weighted by k-mers.

Rounds of tips, bubbles and connections repeat until none goes, at most 10.
A node is unitig i's side s = row 2i + s: side 0 its end (after links),
side 1 its beginning (before links); a link is a signed id +-(j+1).
"""

from __future__ import annotations

import numpy as np

TIP_TOPO_KMULT = 2.5
TIP_RCTC_KMULT = 10.0
TIP_RCTC = 2.0
BUBBLE_KMULT = 3.0
BUBBLE_KADD = 100
EC_KMULT = 9.0
EC_RCTC = 4.0
MAX_ROUNDS = 10
NEG = -1.0


class Graph:
    def __init__(self, k: int, unitigs: list):
        self.k = k
        self.seq = [u["seq"] for u in unitigs]
        self.cov = [float(u["mean"]) for u in unitigs]
        self.rows = []
        for u in unitigs:
            self.rows.append(list(u["after"]))
            self.rows.append(list(u["before"]))
        self.alive = [True] * len(unitigs)

    @property
    def n(self):
        return len(self.seq)

    def nk(self, i):
        return len(self.seq[i]) - self.k + 1

    def kill(self, dead: set) -> None:
        if not dead:
            return
        for i in dead:
            self.alive[i] = False
        for r in range(2 * self.n):
            if not self.alive[r >> 1]:
                self.rows[r] = []
            else:
                self.rows[r] = [t for t in self.rows[r]
                                if self.alive[abs(t) - 1]]

    def _top2(self, r):
        """(best member coverage, its node (least id on a tie), best
        coverage among the other members); dead members read -1."""
        ms = [abs(t) - 1 for t in self.rows[r]]
        cs = [self.cov[m] if self.alive[m] else NEG for m in ms]
        if not ms:
            return NEG, -1, NEG
        top1 = max(cs)
        node1 = min(m for m, c in zip(ms, cs) if c == top1)
        rest = [c for m, c in zip(ms, cs) if m != node1]
        return top1, node1, max(rest) if rest else NEG

    def clip_tips(self) -> int:
        k = self.k
        top = [self._top2(r) for r in range(2 * self.n)]
        dead = set()
        for i in range(self.n):
            d0, d1 = len(self.rows[2 * i]), len(self.rows[2 * i + 1])
            if not (self.alive[i] and (d0 == 0 or d1 == 0)
                    and self.nk(i) <= TIP_RCTC_KMULT * k):
                continue
            anchor = 0 if d0 > 0 else 1
            sib_cov, has_sib = 0.0, False
            for t in self.rows[2 * i + anchor]:
                j = abs(t) - 1
                t1, n1, t2 = top[2 * j + (1 if t > 0 else 0)]
                sib = t1 if n1 != i else t2
                sib_cov = max(sib_cov, max(sib, 0.0))
                has_sib |= (n1 != i) or (t2 > NEG)
            simple = self.nk(i) <= TIP_TOPO_KMULT * k
            weak = self.cov[i] * TIP_RCTC < sib_cov
            if simple or (weak and has_sib):
                dead.add(i)
        self.kill(dead)
        return len(dead)

    def pop_bubbles(self) -> int:
        k = self.k
        max_len = BUBBLE_KMULT * k + BUBBLE_KADD

        def simple(j):
            return (self.alive[j] and len(self.rows[2 * j]) == 1
                    and len(self.rows[2 * j + 1]) == 1
                    and len(self.seq[j]) <= max_len)

        groups = {}
        for r in range(2 * self.n):
            src = r >> 1
            if len(self.rows[r]) < 2 or not self.alive[src]:
                continue
            for t in self.rows[r]:
                j = abs(t) - 1
                if j == src or not simple(j):
                    continue
                dest = self.rows[2 * j + (0 if t > 0 else 1)][0]
                groups.setdefault((r, dest), set()).add(j)
        dead = set()
        for js in groups.values():
            if len(js) < 2:
                continue
            best = min(js, key=lambda j: (-self.cov[j], j))
            dead |= {j for j in js if j != best and self.alive[j]}
        self.kill(dead)
        return len(dead)

    def remove_erroneous_connections(self) -> int:
        dead = set()
        for i in range(self.n):
            if not (self.alive[i] and self.rows[2 * i] and self.rows[2 * i + 1]
                    and self.nk(i) <= EC_KMULT * self.k):
                continue
            cs = [self.cov[abs(t) - 1] for t in self.rows[2 * i]
                  + self.rows[2 * i + 1]
                  if self.alive[abs(t) - 1] and abs(t) - 1 != i]
            if cs and self.cov[i] * EC_RCTC < min(cs):
                dead.add(i)
        self.kill(dead)
        return len(dead)

    def compact(self) -> int:
        M = 2 * self.n
        nxt = [-1] * M
        for a in range(M):
            row = self.rows[a]
            if len(row) != 1 or not self.alive[a >> 1]:
                continue
            t = row[0]
            j = abs(t) - 1
            b = 2 * j + (0 if t > 0 else 1)
            if self.alive[j] and j != a >> 1 and len(self.rows[b ^ 1]) == 1:
                nxt[a] = b
        if all(b < 0 for b in nxt):
            return 0
        merged = sum(b >= 0 for b in nxt) // 2
        prev = [-1] * M
        for a, b in enumerate(nxt):
            if b >= 0:
                prev[b] = a
        head = [-1] * M
        chains = {}  # head -> members in order
        for a in range(M):
            if prev[a] < 0:
                mem = [a]
                while nxt[mem[-1]] >= 0:
                    mem.append(nxt[mem[-1]])
                chains[a] = mem
        seen = set(m for mem in chains.values() for m in mem)
        for a in range(M):
            if a in seen:
                continue
            cyc = [a]
            while nxt[cyc[-1]] != a:
                cyc.append(nxt[cyc[-1]])
            i = cyc.index(min(cyc))
            mem = cyc[i:] + cyc[:i]
            chains[mem[0]] = mem
            seen.update(mem)
        for h, mem in chains.items():
            for m in mem:
                head[m] = h
        tail_of = {h: mem[-1] for h, mem in chains.items()}
        keep = {h for h, mem in chains.items()
                if h <= (tail_of[h] ^ 1) and self.alive[h >> 1]}
        heads = sorted(h for h in keep)
        new_id = {h: i for i, h in enumerate(heads)}
        k = self.k
        seqs, covs, rows = [], [], []
        for h in heads:
            mem = [m for m in chains[h] if self.alive[m >> 1]]
            parts, wsum, nsum = [], 0.0, 0.0
            for idx, a in enumerate(mem):
                s = self.seq[a >> 1]
                s = s if a & 1 == 0 else (3 - s[::-1]).astype(np.uint8)
                parts.append(s if idx == 0 else s[k - 1:])
                nkm = len(self.seq[a >> 1]) - k + 1
                wsum += self.cov[a >> 1] * nkm
                nsum += nkm
            seqs.append(np.concatenate(parts).astype(np.uint8))
            covs.append(wsum / nsum)

        def remap(v):
            jj = abs(v) - 1
            bor = 2 * jj + (0 if v > 0 else 1)
            hh = head[bor]
            if hh in keep:
                return new_id[hh] + 1
            rep = tail_of[hh] ^ 1
            return -(new_id[rep] + 1) if rep in new_id else 0

        for h in heads:
            after = [remap(v) for v in self.rows[tail_of[h]]]
            before = [remap(v) for v in self.rows[h ^ 1]]
            rows.append([v for v in after if v])
            rows.append([v for v in before if v])
        self.seq, self.cov, self.rows = seqs, covs, rows
        self.alive = [True] * len(seqs)
        return merged

    def simplify(self) -> dict:
        stats = {"tips": 0, "bubbles": 0, "ec": 0, "rounds": 0}
        for _ in range(MAX_ROUNDS):
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

    def contigs(self) -> list:
        return [(self.seq[i], self.cov[i]) for i in range(self.n)
                if self.alive[i]]


def contigs(k: int, unitigs: list):
    """(contigs as (codes, mean coverage), stats)."""
    g = Graph(k, unitigs)
    stats = g.simplify()
    return g.contigs(), stats
