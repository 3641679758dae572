"""Vectorized Minia-style graph simplification (pipeline stage 3).

Array reimplementation of :mod:`sh_assembly_tpu.models.simplify` — same
gatb-core semantics (tips / bubbles / erroneous connections / chain
recompaction, Simplifications.cpp constants pinned by
tests/test_simplify_fixtures.py), but every pass is a numpy segment
operation over CSR link arrays instead of per-node Python loops, so a
10^6-unitig graph simplifies in seconds rather than hours.  The reference
delegates this stage to a compiled external Minia fork
(/root/reference/README.md:133-139); this is the in-framework equivalent at
compiled-array speed.

Divergence note (documented, deliberate): the object-graph version applies
removals *sequentially in node order* inside one pass, so a removal can
change a later node's degree/sibling view within the same pass.  Here each
pass computes its kill set against the frozen pass-input state and applies
it atomically, iterating passes to a fixpoint — the parallel formulation of
the same rules (and the natural TPU/array semantics, like the batched
traveled-bit RMW in ops/spectrum.query_set_traveled).  The two agree on all
threshold fixtures and on randomized graphs in
tests/test_simplify_arrays.py; order-sensitive corner cases (e.g. two
mutually-sibling weak tips) may resolve differently, which Minia itself
does not pin down either (its result depends on traversal order).

Graph convention matches models/simplify.SimpleGraph and the reference
(core/unitig_graph.h:25-50): signed id +-(i+1); side 0 = forward end
(after-links), side 1 = beginning (before-links).  Row r = 2*i + side in
the CSR; conveniently row index == oriented-node index (orientation o
exits via side o).

Host spans (``utils/profiling``, all ``sync=False``): ``simplify.build``
(the CSR graph from the Contiger's arrays), ``simplify.tips``,
``simplify.bubbles`` and ``simplify.ec`` (the three passes, summed over
rounds) and ``simplify.compact`` (the three recompactions a round).  Inside
the pipeline's ``simplify`` phase they are its children.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils import profiling
from .simplify import (BUBBLE_KADD, BUBBLE_KMULT, EC_KMULT, EC_RCTC,
                       MAX_ROUNDS, TIP_RCTC, TIP_RCTC_KMULT, TIP_TOPO_KMULT)

_NEG = -1.0  # sentinel coverage for "no such member"


@dataclass
class ArrayGraph:
    """Unitig graph as flat arrays; all simplification passes vectorized."""

    k: int
    seq_codes: np.ndarray  # uint8[total] 2-bit base codes
    offsets: np.ndarray  # int64[n+1] CSR into seq_codes
    cov: np.ndarray  # float64[n] mean k-mer abundance (RCTC metric)
    row_ptr: np.ndarray  # int64[2n+1] CSR over rows r = 2*i + side
    row_val: np.ndarray  # int64[] signed ids +-(j+1)
    alive: np.ndarray  # bool[n]

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @classmethod
    def from_array_unitigs(cls, au) -> "ArrayGraph":
        """Build from models.contiger.ArrayUnitigs (no Python objects)."""
        n = au.n
        deg = np.zeros(2 * n, np.int64)
        deg[0::2] = np.diff(au.after_ptr)
        deg[1::2] = np.diff(au.before_ptr)
        row_ptr = np.zeros(2 * n + 1, np.int64)
        np.cumsum(deg, out=row_ptr[1:])
        row_val = np.empty(row_ptr[-1], np.int64)
        # interleave after/before lists into the row order
        a_pos = row_ptr[0:-1:2]
        b_pos = row_ptr[1::2]
        alens = np.diff(au.after_ptr)
        blens = np.diff(au.before_ptr)
        # scatter by repeat: destination of after_val[j] of unitig i is
        # a_pos[i] + (j - after_ptr[i])
        ia = np.repeat(np.arange(n), alens)
        row_val[a_pos[ia] + np.arange(len(au.after_val))
                - au.after_ptr[ia]] = au.after_val
        ib = np.repeat(np.arange(n), blens)
        row_val[b_pos[ib] + np.arange(len(au.before_val))
                - au.before_ptr[ib]] = au.before_val
        cov = (np.asarray(au.mean, np.float64) if au.mean is not None
               else au.med.astype(np.float64))
        return cls(k=au.k, seq_codes=au.seq_codes.copy(),
                   offsets=au.offsets.copy(), cov=cov,
                   row_ptr=row_ptr, row_val=row_val,
                   alive=np.ones(n, bool))

    @classmethod
    def from_unitig_graph(cls, g) -> "ArrayGraph":
        """Build from the object graph (tests / FASTA reloads)."""
        from ..utils import dna

        n = len(g.unitigs)
        seqs = [np.asarray(dna.encode(u.seq), np.uint8) for u in g.unitigs]
        offsets = np.zeros(n + 1, np.int64)
        np.cumsum([len(s) for s in seqs], out=offsets[1:])
        seq_codes = (np.concatenate(seqs) if n else np.zeros(0, np.uint8))
        cov = np.array(
            [float(u.mean_abundance) or float(u.median_abundance)
             for u in g.unitigs], np.float64)
        deg = np.zeros(2 * n, np.int64)
        deg[0::2] = [len(x) for x in g.after]
        deg[1::2] = [len(x) for x in g.before]
        row_ptr = np.zeros(2 * n + 1, np.int64)
        np.cumsum(deg, out=row_ptr[1:])
        row_val = np.empty(row_ptr[-1], np.int64)
        for i in range(n):
            row_val[row_ptr[2 * i]:row_ptr[2 * i + 1]] = g.after[i]
            row_val[row_ptr[2 * i + 1]:row_ptr[2 * i + 2]] = g.before[i]
        return cls(k=g.k, seq_codes=seq_codes, offsets=offsets, cov=cov,
                   row_ptr=row_ptr, row_val=row_val,
                   alive=np.ones(n, bool))

    # ------------------------------------------------------------------
    # basic derived arrays
    # ------------------------------------------------------------------
    @property
    def n(self) -> int:
        return len(self.cov)

    def _deg(self):
        d = np.diff(self.row_ptr)
        return d[0::2], d[1::2]

    def _nkmers(self):
        return np.diff(self.offsets) - self.k + 1

    def _edge_rows(self):
        """Row index of every CSR edge."""
        return np.repeat(np.arange(2 * self.n, dtype=np.int64),
                         np.diff(self.row_ptr))

    def _kill(self, dead: np.ndarray) -> None:
        """Remove nodes in boolean mask `dead` and every edge touching them."""
        if not dead.any():
            return
        self.alive &= ~dead
        tgt = np.abs(self.row_val) - 1
        rows = self._edge_rows()
        keep = self.alive[rows >> 1] & self.alive[tgt]
        self._filter_edges(keep)

    def _filter_edges(self, keep: np.ndarray) -> None:
        rows = self._edge_rows()[keep]
        self.row_val = self.row_val[keep]
        deg = np.bincount(rows, minlength=2 * self.n).astype(np.int64)
        self.row_ptr = np.zeros(2 * self.n + 1, np.int64)
        np.cumsum(deg, out=self.row_ptr[1:])
        # bincount + repeat keep CSR edge order stable (keep is positional)

    # ------------------------------------------------------------------
    # per-row top-2 coverage stats (distinct member nodes)
    # ------------------------------------------------------------------
    def _row_top2(self):
        """Per row: (max member cov, its node, max cov among members whose
        node differs from the argmax).  Dead members excluded."""
        R = 2 * self.n
        rows = self._edge_rows()
        m = np.abs(self.row_val) - 1
        c = np.where(self.alive[m], self.cov[m], _NEG)
        top1 = np.full(R, _NEG)
        np.maximum.at(top1, rows, c)
        # argmax node: any member achieving top1 (ties: lowest node id)
        hit = c == top1[rows]
        node1 = np.full(R, -1, np.int64)
        big = np.iinfo(np.int64).max
        tmp = np.full(R, big, np.int64)
        np.minimum.at(tmp, rows[hit], m[hit])
        node1 = np.where(tmp == big, -1, tmp)
        # second: max among members with node != node1
        c2 = np.where(m == node1[rows], _NEG, c)
        top2 = np.full(R, _NEG)
        np.maximum.at(top2, rows, c2)
        return top1, node1, top2

    # ------------------------------------------------------------------
    # passes
    # ------------------------------------------------------------------
    def clip_tips(self) -> int:
        """Vectorized Minia tip clipping (simplify.SimpleGraph.clip_tips)."""
        n = self.n
        if n == 0:
            return 0
        d0, d1 = self._deg()
        nk = self._nkmers()
        topo_max = TIP_TOPO_KMULT * self.k
        rctc_max = TIP_RCTC_KMULT * self.k
        # ((d0==0) | (d1==0)) includes ISOLATED nodes (both ends dead):
        # orphaned repeated-error k-mers whose neighbors were deNoised away.
        # They have no anchor edges, so has_sib stays False and only the
        # topological short-tip rule below can remove them — mirroring
        # simplify.SimpleGraph.clip_tips.
        tip = self.alive & ((d0 == 0) | (d1 == 0)) & (nk <= rctc_max)
        if not tip.any():
            return 0
        is_simple = nk <= topo_max
        anchor_side = np.where(d0 > 0, 0, 1)

        top1, node1, top2 = self._row_top2()
        # tip anchor edges: edges in row 2*i + anchor_side of each tip
        rows = self._edge_rows()
        src = rows >> 1
        side = rows & 1
        e_tip = tip[src] & (side == anchor_side[src])
        et_src = src[e_tip]
        t = self.row_val[e_tip]
        j = np.abs(t) - 1
        jrow = 2 * j + np.where(t > 0, 1, 0)  # entry side of signed t
        sib = np.where(node1[jrow] != et_src, top1[jrow], top2[jrow])
        esib_exists = (node1[jrow] != et_src) | (top2[jrow] > _NEG)
        # per-tip aggregation over its anchor edges
        sib_cov = np.zeros(n)
        np.maximum.at(sib_cov, et_src, np.maximum(sib, 0.0))
        has_sib = np.zeros(n, bool)
        np.logical_or.at(has_sib, et_src, esib_exists)

        weak = self.cov * TIP_RCTC < sib_cov
        kill = tip & (is_simple | (weak & has_sib))
        self._kill(kill)
        return int(kill.sum())

    def pop_bubbles(self) -> int:
        """Vectorized 2+-branch bubble popping."""
        n = self.n
        if n == 0:
            return 0
        d0, d1 = self._deg()
        nk_len = np.diff(self.offsets)
        max_len = BUBBLE_KMULT * self.k + BUBBLE_KADD
        simple = self.alive & (d0 == 1) & (d1 == 1) & (nk_len <= max_len)

        rows = self._edge_rows()
        src = rows >> 1
        deg_row = np.diff(self.row_ptr)
        t = self.row_val
        j = np.abs(t) - 1
        cand = (deg_row[rows] >= 2) & simple[j] & (j != src) & self.alive[src]
        if not cand.any():
            return 0
        rc = rows[cand]
        jc = j[cand]
        tc = t[cand]
        # exit row of j walking through signed t: 2j if t>0 else 2j+1;
        # branch j has degree 1 on both sides so it has exactly one exit
        exit_row = 2 * jc + np.where(tc > 0, 0, 1)
        dest = self.row_val[self.row_ptr[exit_row]]
        # group by (anchor row, signed dest); drop duplicate j inside a group
        order = np.lexsort((jc, -self.cov[jc], dest, rc))
        rs, ds, js = rc[order], dest[order], jc[order]
        new_grp = np.r_[True, (rs[1:] != rs[:-1]) | (ds[1:] != ds[:-1])]
        # unique j within group (keep first occurrence = highest cov)
        gid = np.cumsum(new_grp) - 1
        uj = np.lexsort((np.arange(len(js)), js, gid))
        dup = np.zeros(len(js), bool)
        sj, sg = js[uj], gid[uj]
        dup[uj[1:]] = (sj[1:] == sj[:-1]) & (sg[1:] == sg[:-1])
        # members (post-dedup) ranked within group; kill ranks >= 1 when the
        # group has >= 2 distinct branches
        keep_m = ~dup
        grp_sizes = np.bincount(gid[keep_m], minlength=gid[-1] + 1 if len(gid)
                                else 0)
        in_multi = grp_sizes[gid] >= 2
        rank_pos = np.cumsum(keep_m) - 1
        grp_start_pos = np.where(new_grp)[0]
        start_rank = np.maximum.accumulate(
            np.where(new_grp, rank_pos, -1))
        is_winner = keep_m & (rank_pos == start_rank)
        kill_edge = keep_m & in_multi & ~is_winner
        kill = np.zeros(n, bool)
        kill[js[kill_edge]] = True
        kill &= self.alive
        self._kill(kill)
        return int(kill.sum())

    def remove_erroneous_connections(self) -> int:
        """Vectorized EC removal."""
        n = self.n
        if n == 0:
            return 0
        d0, d1 = self._deg()
        nk = self._nkmers()
        cand = self.alive & (d0 > 0) & (d1 > 0) & (nk <= EC_KMULT * self.k)
        if not cand.any():
            return 0
        rows = self._edge_rows()
        src = rows >> 1
        m = np.abs(self.row_val) - 1
        ok = self.alive[m] & (m != src)
        big = np.inf
        c = np.where(ok, self.cov[m], big)
        neigh_min = np.full(n, big)
        np.minimum.at(neigh_min, src, c)
        kill = cand & (neigh_min < big) & (self.cov * EC_RCTC < neigh_min)
        self._kill(kill)
        return int(kill.sum())

    def compact(self) -> int:
        """Merge 1-1 chains via pointer jumping; rebuilds all arrays."""
        n = self.n
        if n == 0:
            return 0
        M = 2 * n
        if len(self.row_val) == 0:
            return 0
        deg_row = np.diff(self.row_ptr)
        # chain edge a -> b: row a (== oriented exit of a) has degree 1,
        # enter row of b (b ^ 1) has degree 1, j alive, no self loop
        a_has = (deg_row == 1) & self.alive[np.arange(M) >> 1]
        t_first = np.where(a_has, self.row_val[
            np.minimum(self.row_ptr[:-1], len(self.row_val) - 1)], 0)
        j = np.abs(t_first) - 1
        b = np.where(t_first != 0, 2 * j + np.where(t_first > 0, 0, 1), -1)
        ok = a_has & (t_first != 0)
        ok &= self.alive[np.maximum(j, 0)]
        ok &= j != (np.arange(M) >> 1)
        bb = np.maximum(b, 0)
        ok &= deg_row[bb ^ 1] == 1
        chain_next = np.where(ok, b, -1).astype(np.int64)
        if not (chain_next >= 0).any():
            return 0

        head, dist, tail_of = _contract_np(chain_next)
        merged = int((chain_next >= 0).sum()) // 2

        # representative selection: keep head h iff h <= flip(tail)
        idx = np.arange(M)
        is_head = head == idx
        mirror_head = tail_of ^ 1
        keep = is_head & (idx <= mirror_head[idx]) & \
            self.alive[idx >> 1]

        # ---- materialize merged unitigs --------------------------------
        member = self.alive[idx >> 1] & keep[head]
        a = idx[member]
        h = head[a]
        d = dist[a]
        order = np.lexsort((d, h))
        a, h = a[order], h[order]
        starts = np.flatnonzero(np.r_[True, h[1:] != h[:-1]])
        plens = np.diff(np.r_[starts, len(h)])
        P = len(starts)
        newid_of_head = np.full(M, -1, np.int64)
        newid_of_head[h[starts]] = np.arange(P)

        node = a >> 1
        orient = a & 1
        seg_len = self.offsets[node + 1] - self.offsets[node]
        contrib = np.where(np.r_[True, h[1:] != h[:-1]],
                           seg_len, seg_len - (self.k - 1))
        new_offsets = np.zeros(P + 1, np.int64)
        np.cumsum(np.add.reduceat(contrib, starts), out=new_offsets[1:])
        total = int(new_offsets[-1])
        new_codes = np.empty(total, np.uint8)
        # gather per member: source positions
        out_pos = np.repeat(
            np.r_[0, np.cumsum(contrib)[:-1]], contrib) + _within(contrib)
        src_off = np.repeat(
            np.where(np.r_[True, h[1:] != h[:-1]], 0, self.k - 1), contrib)
        w = _within(contrib)
        fwd = np.repeat(orient == 0, contrib)
        fwd_idx = np.repeat(self.offsets[node], contrib) + src_off + w
        rev_idx = np.repeat(self.offsets[node + 1], contrib) - 1 \
            - (src_off + w)
        src_idx = np.where(fwd, fwd_idx, rev_idx)
        vals = self.seq_codes[src_idx]
        new_codes[out_pos] = np.where(fwd, vals, 3 - vals)

        nkm = seg_len - self.k + 1
        wsum = np.add.reduceat(self.cov[node] * nkm, starts)
        new_cov = wsum / np.add.reduceat(nkm.astype(np.float64), starts)

        # ---- remap surviving links -------------------------------------
        # external edges attach at: new after = old exit row of tail;
        # new before = old exit row of flip(head)
        tails = a[starts + plens - 1]
        heads_a = h[starts]

        def remap(vals_t):
            jj = np.abs(vals_t) - 1
            bor = 2 * jj + np.where(vals_t > 0, 0, 1)
            hh = head[bor]
            kept = keep[hh]
            rep = np.where(kept, hh, mirror_head[hh])
            nid = newid_of_head[rep]
            sign = np.where(kept, 1, -1)
            return sign * (nid + 1), nid >= 0

        new_vals_parts = []
        new_rows_parts = []
        for side, anchors in ((0, tails), (1, heads_a ^ 1)):
            eptr0 = self.row_ptr[anchors]
            eptr1 = self.row_ptr[anchors + 1]
            cnts = eptr1 - eptr0
            src_rows = np.repeat(np.arange(P), cnts)
            eidx = np.repeat(eptr0, cnts) + _within(cnts)
            vv, okv = remap(self.row_val[eidx])
            new_rows_parts.append((2 * src_rows + side)[okv])
            new_vals_parts.append(vv[okv])
        nr = np.concatenate(new_rows_parts) if new_rows_parts else \
            np.zeros(0, np.int64)
        nv = np.concatenate(new_vals_parts) if new_vals_parts else \
            np.zeros(0, np.int64)
        order2 = np.argsort(nr, kind="stable")
        nr, nv = nr[order2], nv[order2]
        new_ptr = np.zeros(2 * P + 1, np.int64)
        np.cumsum(np.bincount(nr, minlength=2 * P), out=new_ptr[1:])

        self.seq_codes = new_codes
        self.offsets = new_offsets
        self.cov = new_cov
        self.row_ptr = new_ptr
        self.row_val = nv
        self.alive = np.ones(P, bool)
        return merged

    # ------------------------------------------------------------------
    def simplify(self, max_rounds: int = MAX_ROUNDS) -> dict:
        stats = {"tips": 0, "bubbles": 0, "ec": 0, "rounds": 0}
        for _ in range(max_rounds):
            with profiling.phase("simplify.tips", sync=False):
                t = self.clip_tips()
            with profiling.phase("simplify.compact", sync=False):
                self.compact()
            with profiling.phase("simplify.bubbles", sync=False):
                b = self.pop_bubbles()
            with profiling.phase("simplify.compact", sync=False):
                self.compact()
            with profiling.phase("simplify.ec", sync=False):
                e = self.remove_erroneous_connections()
            with profiling.phase("simplify.compact", sync=False):
                self.compact()
            stats["tips"] += t
            stats["bubbles"] += b
            stats["ec"] += e
            stats["rounds"] += 1
            if t + b + e == 0:
                break
        return stats

    def contigs_arrays(self):
        """(seq_codes, offsets, cov) of live contigs, compacted."""
        live = np.flatnonzero(self.alive)
        lens = (self.offsets[live + 1] - self.offsets[live])
        offs = np.zeros(len(live) + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        codes = np.empty(int(offs[-1]), np.uint8)
        src = np.repeat(self.offsets[live], lens) + _within(lens)
        codes[:] = self.seq_codes[src]
        return codes, offs, self.cov[live]

    def contigs(self):
        """List[Unitig] view (tests / small graphs)."""
        from .contiger import Unitig
        from ..utils import dna

        codes, offs, cov = self.contigs_arrays()
        return [Unitig(seq=dna.decode(codes[offs[i]:offs[i + 1]]),
                       median_abundance=int(cov[i]))
                for i in range(len(cov))]


def _within(counts: np.ndarray) -> np.ndarray:
    """[0..c0-1, 0..c1-1, ...] for segment lengths `counts`."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    return (np.arange(total, dtype=np.int64)
            - np.repeat(np.r_[0, np.cumsum(counts)[:-1]], counts))


def _contract_np(chain_next: np.ndarray):
    """Pointer-jumping path contraction (numpy port of
    contiger.contract_paths).  Returns (head, dist, tail_of)."""
    M = len(chain_next)
    idx = np.arange(M, dtype=np.int64)
    rounds = int(np.ceil(np.log2(max(M, 2)))) + 1

    src_ok = chain_next >= 0
    prev = np.full(M, -1, np.int64)
    prev[chain_next[src_ok]] = idx[src_ok]
    has_prev = prev >= 0
    par0 = np.where(has_prev, prev, idx)

    par = par0.copy()
    reached = ~has_prev
    for _ in range(rounds):
        reached |= reached[par]
        par = par[par]
    in_cycle = ~reached

    par = par0.copy()
    lab = idx.copy()
    for _ in range(rounds):
        lab = np.minimum(lab, lab[par])
        par = par[par]
    cut = in_cycle & (lab == idx)
    has_prev &= ~cut

    par = np.where(has_prev, prev, idx)
    off = has_prev.astype(np.int64)
    for _ in range(rounds):
        off = off + off[par]
        par = par[par]
    head, dist = par, off

    is_tail = (chain_next < 0) | (in_cycle & (chain_next == head))
    tail_of = np.zeros(M, np.int64)
    tail_of[head[is_tail]] = idx[is_tail]
    return head, dist, tail_of


def simplify_to_contigs_arrays(au, max_rounds: int = MAX_ROUNDS):
    """ArrayUnitigs -> (contig seq_codes, offsets, cov, stats); the
    no-Python-objects pipeline path."""
    with profiling.phase("simplify.build", sync=False):
        g = ArrayGraph.from_array_unitigs(au)
    stats = g.simplify(max_rounds)
    codes, offs, cov = g.contigs_arrays()
    return codes, offs, cov, stats


def write_contigs_arrays(path: str, codes: np.ndarray, offsets: np.ndarray,
                         cov: np.ndarray) -> None:
    """Minia-style contig FASTA from arrays (buffered, no per-contig
    Python string objects)."""
    from ..utils import dna

    ascii_buf = dna._CODE2ASCII[codes]
    with open(path, "wb", buffering=1 << 22) as f:
        for i in range(len(cov)):
            ln = int(offsets[i + 1] - offsets[i])
            f.write(f">{i} LN:i:{ln} km:f:{int(cov[i])}\n".encode())
            f.write(ascii_buf[offsets[i]:offsets[i + 1]].tobytes())
            f.write(b"\n")


def contig_stats_arrays(offsets: np.ndarray, genome_size: int | None = None):
    """Assembly summary from contig length array (same fields as
    simplify.contig_stats)."""
    lens = np.sort(np.diff(offsets))[::-1]
    total = int(lens.sum())
    out = {"n_contigs": len(lens), "total_len": total,
           "max_len": int(lens[0]) if len(lens) else 0}
    acc = np.cumsum(lens)
    i = np.searchsorted(acc, (total + 1) // 2)
    out["N50"] = int(lens[i]) if len(lens) else 0
    if genome_size:
        j = np.searchsorted(acc, (genome_size + 1) // 2)
        out["NG50"] = int(lens[j]) if j < len(lens) else 0
    return out
