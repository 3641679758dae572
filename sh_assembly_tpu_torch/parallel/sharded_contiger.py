"""Sharded Contiger: a distributed node store, probe joins and count
queries over the counting mesh.

Counterpart of ``sh_assembly_tpu/parallel/sharded_contiger.py``.  The
spectrum stays sharded by key range (the counting rule, parallel/
sharded.py) and the node store by k-mer range (the top bits of the
canonical k-mer's high word).  Every cross-shard lookup is a sorted quota
all_to_all round trip:

  count query:  pack (key | query index) -> sort -> rows per owner ->
                all_to_all -> the owner's count join (kernel K2 on CUDA
                tensors) -> pack (index | count) -> all_to_all back ->
                scatter by index
  node join:    route (hi, lo, index) by k-mer owner -> the owner's
                ``join2`` against its store (kernel K7 on CUDA tensors)
                -> global index = shard * cap + local -> all_to_all back
  probes:       a shard's nodes' successor and sibling probes and their
                keys (``probe_cuda.node_probes``, kernel K8 on CUDA
                tensors)
  store fold:   route (k-mer, inverted seed flag) triples to their owners,
                sort them, fold them into the owner's store (kernel K3 on
                CUDA tensors: the single-device flush's fold)

Contraction and the host assembly are the single-device tail
(``contiger.finalize_unitigs``: kernels K9 and K10 on CUDA tensors) on the
shards' stores concatenated, where they lie: a
node's index is shard * node_cap_local + local, so the unitig numbering
follows the JAX sharded run and not the single-device one.

The collective steps run over any mesh, with the shards spread over
processes (``collectives.Distributed``): every width that crosses shards
(rows, index bits) and every decision that raises (drops, the store's
fill) is agreed through ``pmax`` or ``psum``.  The host tail needs every
shard's store and stays single-process, as the JAX layer's is
(``shard_parts`` runs the steps, ``finish_parts`` the tail).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable

import numpy as np
import torch

from .. import config as cfg
from ..io import fastq
from ..models import contiger
from ..ops import bits, kmerpack as kp, merge128_cuda, packio, \
    probe_cuda, spectrum as sp, stage_cuda
from ..utils import profiling
from ..utils.logging import log
from .sharded import ShardedCounter, quota_rows, row_width, \
    spans_processes, split_rows

SENT = bits.SENTINEL
_MASK32 = 0xFFFFFFFF


def _edges(values, device) -> torch.Tensor:
    """Unsigned 64-bit boundaries as flipped int64 (searchsorted needles)."""
    return bits.flip(bits.from_u64_np(np.array(values, np.uint64), device))


@dataclass(frozen=True)
class ShardedContiger:
    """The Contiger's collective steps over the counting mesh."""

    counter: ShardedCounter
    k: int
    abundance_min: int
    node_cap_local: int  # node-store capacity per shard (power of two)
    quota_slack: float = 2.0

    @property
    def mesh(self):
        return self.counter.mesh

    @property
    def n_shards(self) -> int:
        return self.counter.n_shards

    @property
    def key_bits(self) -> int:
        return self.counter.key_bits

    def _quota(self, per_shard_windows: int) -> int:
        n = self.n_shards
        return int(np.ceil(per_shard_windows / n * self.quota_slack))

    def _kmer_edges(self, device) -> torch.Tensor:
        """Owner boundaries on the canonical k-mer's high word."""
        n, sb = self.n_shards, self.counter.shard_bits
        return _edges([(o << (64 - sb)) if o < n else (1 << 64) - 1
                       for o in range(n + 1)], device)

    def _route(self, cols, bounds, Q: int, fills):
        """Exchange every shard's sorted columns by owner: row o of shard s
        holds cols[s][c][bounds[s][o]:bounds[s][o + 1]], at most Q of them,
        padded with fills[c] to the widest count in the mesh
        (``row_width``).  The columns go one at a time and are released as
        they are cut.  Returns (the received columns per shard, each [n *
        width], the entries beyond a quota on this process's shards,
        width)."""
        width = row_width(self.mesh, bounds, Q)
        recv, drop = [], 0
        for c, fill in enumerate(fills):
            rows = []
            for col, b in zip(cols, bounds):
                r, d = quota_rows(col[c], b, Q, fill, width)
                col[c] = None
                rows.append(r)
                if c == 0:
                    drop = drop + d
            recv.append(self.mesh.all_to_all(rows))
            del rows
        return list(zip(*recv)), drop, width

    # -- distributed count queries (round trip) -----------------------------
    def _dist_counts(self, specs, keys, Qd: int):
        """Counts of every shard's query keys (-1 = none) against the
        key-range-sharded spectrum -> (int32 counts per shard, dropped).
        Empties ``keys``."""
        n, kb = self.n_shards, self.key_bits
        if n == 1:
            return [sp.query_join_auto(specs[0], keys.pop(), kb)], 0
        dev = keys[0].device
        sizes = [q.numel() for q in keys]
        # the owner decodes every sender's rows with one width
        idx_bits = max(int(np.ceil(np.log2(max(self.mesh.pmax(sizes), 2)))),
                       1)
        if kb + idx_bits > 63:
            raise ValueError("dist-count packing overflow")
        sb = self.counter.shard_bits
        edges = _edges([(o << (kb - sb)) << idx_bits for o in range(n + 1)],
                       dev)
        cols, bounds = [], []
        for q in keys:
            # only real keys are packed: the -1 ones would sort last and
            # fall outside every owner's range
            at = torch.nonzero(q != SENT).squeeze(1)
            srt = bits.usort((q[at] << idx_bits) | at)
            bounds.append(torch.searchsorted(bits.flip(srt), edges))
            cols.append([srt])
            del at
        keys.clear()
        recv, drop, width = self._route(cols, bounds, Qd, [SENT])
        resp = []
        for i, spec in enumerate(specs):
            (r,) = recv[i]
            recv[i] = None
            sent = r == SENT
            c = sp.query_join_auto(
                spec, torch.where(sent, SENT, bits.srl(r, idx_bits)), kb)
            resp.append(torch.where(
                sent, SENT, ((r & ((1 << idx_bits) - 1)) << 32) | c.long()
            ).reshape(n, width))
            del r, sent, c
        out = []
        for b, Q in zip(self.mesh.all_to_all(resp), sizes):
            ridx = bits.srl(b, 32)
            counts = torch.zeros(Q + 1, dtype=torch.int32, device=dev)
            counts[torch.where(ridx < Q, ridx, Q)] = (b & _MASK32).int()
            out.append(counts[:Q])
        return out, drop

    # -- distributed node-store join (round trip) ---------------------------
    def _dist_join(self, stores, queries, Qd: int):
        """Global node index of every shard's (qhi, qlo) k-mer queries
        against the k-mer-range-sharded store (-1 = absent) -> (int64
        indices per shard, dropped).  Empties ``queries``."""
        n, Cl = self.n_shards, self.node_cap_local
        if n == 1:
            (st,), ((qh, ql),) = stores, queries
            return [kp.join2(st.hi, st.lo, qh, ql).long()], 0
        dev = stores[0].hi.device
        sizes = [qh.numel() for qh, _ in queries]
        edges = self._kmer_edges(dev)
        cols, bounds = [], []
        for qh, ql in queries:
            perm = kp.sort_pairs(qh, ql)
            sh = qh[perm]
            # a k-mer whose high word is all ones sorts at the last edge
            # and is routed nowhere, as in the JAX layer
            bounds.append(torch.searchsorted(bits.flip(sh), edges).clamp(
                max=sh.numel()))
            cols.append([sh, ql[perm], perm])
            del perm, sh
        queries.clear()
        recv, drop, width = self._route(cols, bounds, Qd, [SENT] * 3)
        resp = []
        for i, (me, st) in enumerate(zip(self.mesh.shard_ids, stores)):
            gh, gl, go = recv[i]
            recv[i] = None
            j = kp.join2(st.hi, st.lo, gh, gl).long()
            gidx = torch.where(j >= 0, me * Cl + j, -1)
            resp.append(torch.where(go == SENT, SENT, (go << 32) | (gidx + 1))
                        .reshape(n, width))
            del gh, gl, go, j, gidx
        out = []
        for b, Q in zip(self.mesh.all_to_all(resp), sizes):
            ridx = bits.srl(b, 32)
            pos = torch.where((b != SENT) & (ridx < Q), ridx, Q)
            idx = torch.full((Q + 1,), -1, dtype=torch.int64, device=dev)
            idx[pos] = (b & _MASK32) - 1
            out.append(idx[:Q])
        return out, drop

    # -- routing and the store fold -----------------------------------------
    def _route_and_merge(self, stores, cands, Qc: int,
                         frontier: bool = False):
        """Route every shard's (hi, lo, nflag) candidate k-mers (nflag 0 =
        seed) to their owners and fold them into the owners' stores, first
        copy under (hi, lo, nflag) order so seed flags OR.  Updates the
        stores in place and empties ``cands`` -> (n_live per shard, which
        may exceed the capacity, dropped, and with ``frontier`` the
        distinct (hi, lo) each owner received)."""
        n, Cl = self.n_shards, self.node_cap_local
        drop = 0
        if n > 1:
            edges = self._kmer_edges(stores[0].hi.device)
            cols, bounds = [], []
            for chi, clo, nflag in cands:
                perm = kp.sort_pairs(chi, clo)
                sh = chi[perm]
                bounds.append(torch.searchsorted(bits.flip(sh), edges).clamp(
                    max=sh.numel()))
                cols.append([sh, clo[perm], nflag[perm]])
                del perm, sh
            cands.clear()
            cands, drop, _ = self._route(cols, bounds, Qc, [SENT, SENT, 1])
        n_live, fresh = [], []
        for i, st in enumerate(stores):
            chi, clo, nflag = cands[i]
            cands[i] = None
            perm = kp.sort_pairs(chi, clo, nflag)
            chi, clo, nflag = chi[perm], clo[perm], nflag[perm]
            o_hi, o_lo, o_nf, nl = merge128_cuda.merge128(
                st.hi, st.lo, 1 - st.seed, st.n, chi, clo, nflag, Cl)
            st.hi, st.lo, st.seed = o_hi, o_lo, 1 - o_nf
            st.n = min(int(nl), Cl)
            n_live.append(int(nl))
            if frontier:
                first = torch.ones(chi.shape, dtype=torch.bool,
                                   device=chi.device)
                first[1:] = (chi[1:] != chi[:-1]) | (clo[1:] != clo[:-1])
                keep = first & ~((chi == SENT) & (clo == SENT))
                fresh.append((chi[keep], clo[keep]))
            del chi, clo, nflag, perm
        return n_live, drop, fresh

    # -- phase A: node collection -------------------------------------------
    def collect(self, specs, stores, packed, nmask, lengths, seed_cols,
                Lp: int):
        """One batch (per-shard row blocks of the packed transport format)
        -> (n_live per shard, dropped).  Every valid N-free window whose
        key counts at least abundance_min is a node; a window at its read's
        seed column is a seed.

        Each shard's rows are staged by ``stage_cuda.stage_windows`` (kernel
        K6 on CUDA tensors) under the mesh key rule: the key of every valid
        window, N-containing ones included, goes to the count round trip,
        and the canonical (hi, lo) and seed flag of every valid N-free one
        wait for its count."""
        k, kb = self.k, self.key_bits
        W = Lp - k + 1
        Qc = self._quota(packed[0].shape[0] * W)
        keys, staged = [], []
        for p, m, ln, sc in zip(packed, nmask, lengths, seed_cols):
            n = ln.numel() * W
            hi, lo, key = (torch.empty(n, dtype=torch.int64, device=p.device)
                           for _ in range(3))
            seed = torch.empty(n, dtype=torch.uint8, device=p.device)
            stage_cuda.stage_windows(hi, lo, key, seed, 0, p, m, ln, sc, k,
                                     kb, keys="valid")
            keys.append(key)
            staged.append((hi, lo, seed))
        counts, d0 = self._dist_counts(specs, keys, Qc)
        cands = []
        for (hi, lo, seed), cnt in zip(staged, counts):
            at = ~((hi == SENT) & (lo == SENT)) & \
                (cnt >= self.abundance_min)
            cands.append((hi[at], lo[at], 1 - seed[at]))
        del staged, counts
        n_live, d1, _ = self._route_and_merge(stores, cands, Qc)
        return n_live, d0 + d1

    # -- phase A2: phantom closure ------------------------------------------
    def phantom(self, specs, stores, frontiers):
        """One closure round over the mesh: every shard probes the 16
        candidate k-mers (8 successors of both orientations and 8 suffix
        siblings) of its frontier nodes, keeps those that pass the count
        filter and are absent from the distributed store, and routes them
        to their owners -> (n_live per shard, nodes added over all shards,
        dropped, the next frontiers: the nodes each owner added).

        The JAX layer probes every node every round.  A node probed in an
        earlier round adds nothing later (its candidates are stored by now
        or fail a count that does not change), so probing the last round's
        additions gives the same nodes in the same rounds."""
        k, Cl = self.k, self.node_cap_local
        Qc = self._quota(16 * Cl)
        probes, joins, keys = [], [], []
        for hi, lo in frontiers:
            pkeys, phi, plo, _ = probe_cuda.node_probes(
                hi, lo, k, self.key_bits, "closure")
            ahi, alo = phi.reshape(-1), plo.reshape(-1)
            probes.append((ahi, alo))
            joins.append((ahi, alo))
            keys.append(pkeys.reshape(-1))
            del pkeys, phi, plo
        frontiers.clear()
        all_j, dj = self._dist_join(stores, joins, Qc)
        cnts, dc = self._dist_counts(specs, keys, Qc)
        old_n = [st.n for st in stores]
        cands = []
        for (ahi, alo), j, c in zip(probes, all_j, cnts):
            ph = (c >= self.abundance_min) & (j < 0)
            cands.append((ahi[ph], alo[ph],  # phantoms never seed
                          torch.ones(int(ph.sum()), dtype=torch.uint8,
                                     device=ahi.device)))
        del probes, all_j, cnts
        n_live, d1, fresh = self._route_and_merge(stores, cands, Qc,
                                                  frontier=True)
        n_new = self.mesh.psum(a - b for a, b in zip(n_live, old_n))
        return n_live, n_new, dj + dc + d1, fresh

    # -- phase B: graph probes ----------------------------------------------
    def probe(self, specs, stores):
        """The 8 successor probes of both orientations and each node's own
        count -> per shard (ecount[2Cl], succ_gidx[2Cl], succ_orient[2Cl],
        node_counts[Cl], valid[Cl]) with GLOBAL indices (zeros in the
        store's empty slots), and dropped."""
        k, Cl = self.k, self.node_cap_local
        Qc = self._quota(9 * Cl)
        Qj = self._quota(8 * Cl)
        joins, keys, flips = [], [], []
        for st in stores:
            # the live nodes' 8 successor probes and own key
            pkeys, shi, slo, sflip = probe_cuda.node_probes(
                st.hi[:st.n], st.lo[:st.n], k, self.key_bits, "graph")
            keys.append(pkeys.reshape(-1))
            joins.append((shi.reshape(-1), slo.reshape(-1)))
            flips.append(sflip)
            del pkeys, shi, slo
        all_j, dj = self._dist_join(stores, joins, Qj)
        all_c, dc = self._dist_counts(specs, keys, Qc)
        out = []
        for st, sflip, j, c in zip(stores, flips, all_j, all_c):
            N = st.n
            j, c = j.reshape(8, N), c.reshape(9, N)
            dev = j.device
            ec_o, sj_o, sp_o = [], [], []
            for o in range(2):
                ec = torch.zeros(Cl, dtype=torch.int32, device=dev)
                uj = torch.zeros(Cl, dtype=torch.int64, device=dev)
                up = torch.zeros(Cl, dtype=torch.int32, device=dev)
                for X in range(4):
                    e = c[1 + o * 4 + X] >= self.abundance_min
                    ec[:N] += e.int()
                    uj[:N] += torch.where(e, j[o * 4 + X], 0)
                    up[:N] += torch.where(e, sflip[o * 4 + X], 0)
                ec_o.append(ec)
                sj_o.append(uj)
                sp_o.append(up)
            counts = torch.zeros(Cl, dtype=torch.int32, device=dev)
            counts[:N] = c[0]
            out.append((torch.stack(ec_o, dim=1).reshape(-1),
                        torch.stack(sj_o, dim=1).reshape(-1),
                        torch.stack(sp_o, dim=1).reshape(-1), counts,
                        torch.arange(Cl, device=dev) < N))
        return out, dj + dc


def node_cap_for(mesh, specs) -> int:
    """Per-shard node-store capacity: the busiest shard's expected share of
    the distinct keys summed over the mesh, with 1/8 slack, as a power of
    two.

    A shard owns a range of the canonical k-mers' top bits, and a canonical
    k-mer is the smaller of two near-uniform words, so shard 0 expects
    1 - (1 - 1/n)^2 of the nodes (7/16 at n = 4), not 1/n.  The JAX layer
    sizes for 1/n (``nd // n + nd // (8 * n) + 1024``) and overflows on a
    genome of a few Mbp at any n > 1; at n = 1 both rules agree.  Nothing
    the Contiger outputs depends on the capacity.
    """
    n = mesh.n
    nd = max(mesh.psum(s.ndistinct for s in specs), 1024)
    busiest = nd - nd * (n - 1) ** 2 // n ** 2
    per = busiest + busiest // 8 + 1024
    return 1 << int(np.ceil(np.log2(per)))


@dataclass
class ShardPart:
    """One shard's share of the Contiger's collective steps: its node store
    (k-mer words and seed flags, ``node_cap_local`` slots) and its graph
    probes (``ShardedContiger.probe``)."""

    hi: torch.Tensor  # int64[Cl]
    lo: torch.Tensor  # int64[Cl]
    seed: torch.Tensor  # uint8[Cl]
    ecount: torch.Tensor  # int32[2Cl]
    succ: torch.Tensor  # int64[2Cl], global node indices
    orient: torch.Tensor  # int32[2Cl]
    counts: torch.Tensor  # int32[Cl]
    valid: torch.Tensor  # bool[Cl]


def shard_parts(
    sc: ShardedCounter,
    specs: list[sp.Spectrum],
    batches: Iterable[fastq.Batch],
    params: cfg.ContigerParams,
    node_cap_local: int | None = None,
    quota_slack: float = 2.0,
) -> tuple[list[ShardPart], bool] | None:
    """The Contiger's collective steps over the mesh: node collection, the
    phantom closure and the graph probes -> (the parts of the shards this
    process holds, whether the batches carried seed columns), or None when
    the stream was empty.  Every process of the mesh feeds the same number
    of batches (``multihost.coordinated_stream``)."""
    k = params.k
    mesh = sc.mesh
    dev = sc.device
    contiger.check_solid_cap(sc.key_bits, params.solid_kmer_abundance_max)
    if node_cap_local is None:
        node_cap_local = node_cap_for(mesh, specs)
    st = ShardedContiger(counter=sc, k=k,
                         abundance_min=params.kmer_abundance_min,
                         node_cap_local=node_cap_local,
                         quota_slack=quota_slack)
    Cl = node_cap_local

    # ---- phase A over host batches ----------------------------------------
    stores = [contiger._NodeStore(
        hi=torch.full((Cl,), SENT, dtype=torch.int64, device=dev),
        lo=torch.full((Cl,), SENT, dtype=torch.int64, device=dev),
        seed=torch.zeros(Cl, dtype=torch.uint8, device=dev))
        for _ in mesh.shard_ids]
    n_peak = 0
    B = Lp = None
    dropped = 0
    saw_seed_meta = False
    with profiling.phase("contiger:mesh collect"):
        for b in batches:
            if isinstance(b, fastq.PackedBatch):
                # native transport format: already 2-bit packed + N-masked
                packed, nmask, Lp_b = b.packed, b.nmask, b.row_len
            else:
                codes = b.codes
                L = codes.shape[1]
                Lp_b = (L + 7) // 8 * 8
                if Lp_b != L:
                    codes = np.pad(codes, ((0, 0), (0, Lp_b - L)),
                                   constant_values=5)
                packed, nmask = packio.pack_np(codes)
            rows = packed.shape[0]
            if Lp is None:
                Lp, B = Lp_b, rows
            if Lp_b != Lp or rows != B:
                raise ValueError("mixed batch geometry")
            if b.seed_col is not None:
                saw_seed_meta = True
                seedc = np.asarray(b.seed_col, np.int32)
            else:
                seedc = np.full(rows, -1, np.int32)
            n_live, d = st.collect(
                specs, stores, *(split_rows(mesh, a) for a in (
                    packed, nmask, np.asarray(b.lengths, np.int32), seedc)),
                Lp)
            n_peak = max(n_peak, max(n_live))
            dropped += int(d)
    if Lp is None:
        return None
    # agreed, so that every process raises together
    dropped = mesh.psum([dropped])
    if dropped:
        raise RuntimeError(
            f"sharded collect dropped {dropped} routed k-mers: raise "
            f"quota_slack")
    n_peak = mesh.pmax([n_peak])
    if n_peak >= Cl:
        raise RuntimeError(
            f"node store overflow: shard peak {n_peak} reached cap {Cl}; "
            f"pass a larger node_cap_local")

    # ---- phase A2: phantom closure ----------------------------------------
    max_rounds = 8
    frontiers = [(s.hi[:s.n], s.lo[:s.n]) for s in stores]
    with profiling.phase("contiger:mesh phantom closure"):
        for rnd in range(max_rounds):
            n_live, n_new, d, frontiers = st.phantom(specs, stores,
                                                     frontiers)
            if mesh.psum([d]):
                raise RuntimeError(
                    "sharded phantom closure dropped routed k-mers: raise "
                    "quota_slack")
            n_peak = mesh.pmax([n_peak, *n_live])
            if n_peak >= Cl:
                raise RuntimeError(
                    f"node store overflow during phantom closure: shard "
                    f"peak {n_peak} reached cap {Cl}")
            if n_new == 0:
                break
            log(f"[Contiger/sharded] phantom closure round {rnd + 1}: "
                f"{n_new} nodes added")
        else:
            raise RuntimeError(
                f"sharded phantom closure not converged after {max_rounds} "
                f"rounds: the node set would silently diverge from reference "
                f"candidate semantics; raise key_bits (hash collisions are "
                f"pathologically dense)")

    # ---- phase B ----------------------------------------------------------
    with profiling.phase("contiger:mesh probe graph"):
        probes, d = st.probe(specs, stores)
        if mesh.psum([d]):
            raise RuntimeError("sharded probe dropped routed queries: raise "
                               "quota_slack")
    parts = [ShardPart(s.hi, s.lo, s.seed, *p)
             for s, p in zip(stores, probes)]
    return parts, mesh.pmax([saw_seed_meta]) > 0


def finish_parts(parts: list[ShardPart], saw_seed_meta: bool,
                 params: cfg.ContigerParams) -> contiger.ArrayUnitigs:
    """The single-device tail on every shard's part, in global shard order:
    the chain rule on global indices (numpy), then contraction and the
    host assembly on the parts' device (``contiger.finalize_unitigs``)."""
    n, Cl = len(parts), parts[0].hi.shape[0]
    ec, sjg, sog = (torch.cat(x).cpu().numpy().astype(np.int64) for x in (
        [p.ecount for p in parts], [p.succ for p in parts],
        [p.orient for p in parts]))
    node_counts = torch.cat([p.counts for p in parts])
    real = torch.cat([p.valid for p in parts]).cpu().numpy()

    # ---- combine chain rule on host (global numbering) --------------------
    Npt = n * Cl
    target = np.where(sjg >= 0, 2 * sjg + sog, -1)
    flip_target = np.where(sjg >= 0, 2 * sjg + (1 - sog), -1)
    # lanes with ecount != 1 carry summed indices that may point anywhere:
    # clamp the gather; the ok rule masks them
    ft = np.clip(flip_target, 0, 2 * Npt - 1)
    ok = (ec == 1) & (target >= 0) & (ec[ft] == 1)
    a_idx = np.arange(2 * Npt, dtype=np.int64)
    ok &= (target != a_idx) & (target != (a_idx ^ 1))
    chain_next = np.where(ok, target, -1).astype(np.int32)

    # a store only grows, so its last fill is its peak
    peak = max(int(p.valid.sum()) for p in parts)
    log(f"[Contiger/sharded] {int(real.sum())} distinct solid k-mers over "
        f"{n} shards (peak shard fill {peak}/{Cl})")
    is_seed = (torch.cat([p.seed for p in parts]) != 0
               if saw_seed_meta else None)
    hi = torch.cat([p.hi for p in parts])
    return contiger.finalize_unitigs(
        hi, torch.cat([p.lo for p in parts]), real, node_counts,
        torch.from_numpy(chain_next).to(hi.device), params, is_seed=is_seed)


def assemble_unitigs_sharded(
    sc: ShardedCounter,
    specs: list[sp.Spectrum],
    batches: Iterable[fastq.Batch],
    params: cfg.ContigerParams,
    node_cap_local: int | None = None,
    quota_slack: float = 2.0,
) -> contiger.ArrayUnitigs:
    """Full Contiger over a sharded spectrum -> ArrayUnitigs.

    Node collection, the phantom closure and the graph probes run over
    the mesh; contraction and the host assembly are the single-device
    tail (``contiger.finalize_unitigs``).  Single-process only: the tail
    reads every shard's store (ROADMAP §3, fault 10).
    """
    if spans_processes(sc.mesh):
        raise ValueError(
            "assemble_unitigs_sharded ends in a host tail that reads every "
            "shard's store, but other processes hold some of them "
            "(reference fault 10: the JAX layer's tail cannot gather across "
            "processes either); run shard_parts in every process and "
            "finish_parts on all the parts in one")
    got = shard_parts(sc, specs, batches, params, node_cap_local,
                      quota_slack)
    if got is None:
        return contiger.ArrayUnitigs.empty(params.k)
    return finish_parts(*got, params)
