"""The plain reference's unitig graph, in plain PyTorch (any device) with
the components found by SciPy.

Semantics (the Contiger of SH-assembly, contig_assembly.cpp, as the
configuration states it):

  * nodes: the distinct canonical k-mers of the reads' windows whose key
    is counted at least ``abundance_min`` times;
  * phantoms: a neighbour probe whose key is counted at least
    ``abundance_min`` times is a node even when its k-mer is in no read.
    The probes of a k-mer, in both orientations, are its four successors
    and its four first-base siblings; nodes are closed over them;
  * an oriented node has an edge to each successor whose key passes the
    count filter; a -> b is a chain edge when a has one successor b, b has
    one predecessor, and b is neither a nor a's reverse;
  * a unitig is a maximal chain, a cycle cut at its least oriented index
    (2 x node + orientation, nodes numbered sorted, each round's phantoms
    after them); of a unitig and its mirror, the one whose first k-mer is
    not above its mirror's is kept;
  * links join a unitig's last k-1 bases to the first k-mer of another (or
    the reverse of its last); first-base siblings of a unitig's ends join
    it to other unitigs for connectivity alone;
  * a connected component is kept if a member k-mer is some read's middle
    k-mer and counted within [solid_min, solid_max].

Returns plain Python data: per unitig its sequence (bytes, ACGT), median
and mean count, and after/before links as signed ids (+-(id+1)).
"""

from __future__ import annotations

import numpy as np
import torch

from . import kmers as km
from .spectrum import lookup

ROWS = 1 << 17
MAX_ROUNDS = 64


def _unique_rows(hi, lo, *extra):
    """Sorted distinct (hi, lo) with the rows of ``extra`` of each run's
    first member, and a run id per input row."""
    perm = km.lexsort_pairs(hi, lo)
    hs, ls = hi[perm], lo[perm]
    new = torch.ones_like(hs, dtype=torch.bool)
    new[1:] = (hs[1:] != hs[:-1]) | (ls[1:] != ls[:-1])
    run = torch.empty_like(perm)
    run[perm] = torch.cumsum(new.long(), 0) - 1
    first = perm[new]
    return (hi[first], lo[first], *[e[first] for e in extra]), run


def collect(reads, k, key_bits, keys, counts, abundance_min, bits=64):
    """Nodes of the reads: (hi, lo, fh, rh, mid) sorted, fh/rh the hashes of
    the canonical orientation, ``mid`` 1 where the k-mer is some read's
    middle k-mer."""
    parts = []
    L = reads.shape[1]
    mid = L // 2 if L // 2 + k <= L else -1
    for a in range(0, reads.shape[0], ROWS):
        r = reads[a:a + ROWS]
        fh, rh = km.window_hashes(r, k, bits)
        hi, lo = km.pack_windows(r, k)
        chi, clo, flip = km.canonical(hi, lo, k)
        cfh = torch.where(flip, rh, fh)
        crh = torch.where(flip, fh, rh)
        solid = lookup(keys, counts, km.key_of(fh, rh, key_bits)) \
            >= abundance_min
        m = torch.zeros_like(hi)
        if mid >= 0:
            m[:, mid] = 1
        sel = solid.reshape(-1)
        cols = [t.reshape(-1)[sel] for t in (chi, clo, cfh, crh, m)]
        (uh, ul, uf, ur), run = _unique_rows(*cols[:4])
        um = torch.zeros_like(uh)
        um.scatter_reduce_(0, run, cols[4], "amax")
        parts.append((uh, ul, uf, ur, um))
    cat = [torch.cat([p[i] for p in parts]) for i in range(5)]
    (hi, lo, fh, rh), run = _unique_rows(*cat[:4])
    mid_flag = torch.zeros_like(hi)
    mid_flag.scatter_reduce_(0, run, cat[4], "amax")
    return hi, lo, fh, rh, mid_flag


def _orient(hi, lo, fh, rh, k, o):
    if o == 0:
        return hi, lo, fh, rh
    rhi, rlo = km.revcomp(hi, lo, k)
    return rhi, rlo, rh, fh


def probes(hi, lo, fh, rh, k, bits=64):
    """The 16 probes of each k-mer: per orientation, four successors then
    four first-base siblings; yields (hi, lo, fh, rh) of each probe as
    written (not canonical)."""
    for o in range(2):
        h, lw, f, r = _orient(hi, lo, fh, rh, k, o)
        first = km.first_base(h, k)
        for x in range(4):
            nh, nl = km.shift_in(h, lw, x, k)
            nf, nr = km.succ_hash(f, r, first, x, k, bits)
            yield nh, nl, nf, nr
        for x in range(4):
            nf, nr = km.sibling_hash(f, r, first, x, k, bits)
            yield km.set_first(h, x, k), lw, nf, nr


def close(hi, lo, fh, rh, k, key_bits, keys, counts, abundance_min,
          bits=64):
    """Nodes closed over phantoms; each round's new nodes, sorted, are
    appended after the nodes before them."""
    order_h, order_l, order_f, order_r = [hi], [lo], [fh], [rh]
    sh, sl = hi, lo  # sorted table of all nodes so far
    fr = (hi, lo, fh, rh)
    for _ in range(MAX_ROUNDS):
        cand = [[], [], [], []]
        for a in range(0, fr[0].numel(), ROWS * 8):
            part = [t[a:a + ROWS * 8] for t in fr]
            for ph, pl, pf, pr in probes(*part, k, bits):
                ok = lookup(keys, counts, km.key_of(pf, pr, key_bits)) \
                    >= abundance_min
                ph, pl, pf, pr = ph[ok], pl[ok], pf[ok], pr[ok]
                ch, cl, flip = km.canonical(ph, pl, k)
                new = km.find_rows(sh, sl, ch, cl) < 0
                cand[0].append(ch[new])
                cand[1].append(cl[new])
                cand[2].append(torch.where(flip, pr, pf)[new])
                cand[3].append(torch.where(flip, pf, pr)[new])
        cat = [torch.cat(c) for c in cand]
        if cat[0].numel() == 0:
            break
        (nh, nl, nf, nr), _ = _unique_rows(*cat)
        order_h.append(nh)
        order_l.append(nl)
        order_f.append(nf)
        order_r.append(nr)
        (sh, sl), _ = _unique_rows(torch.cat([sh, nh]), torch.cat([sl, nl]))
        fr = (nh, nl, nf, nr)
    else:
        raise RuntimeError("phantom closure did not converge")
    return (torch.cat(order_h), torch.cat(order_l), torch.cat(order_f),
            torch.cat(order_r), sh, sl)


def chain_edges(hi, lo, fh, rh, sh, sl, k, key_bits, keys, counts,
                abundance_min, bits=64):
    """chain_next over oriented nodes a = 2 x node + o (-1: none)."""
    n = hi.numel()
    dev = hi.device
    # row of each sorted-table entry in node order
    row_of_sorted = torch.empty(n, dtype=torch.int64, device=dev)
    row_of_sorted[km.find_rows(sh, sl, hi, lo)] = torch.arange(
        n, device=dev)
    nsucc = torch.zeros(2 * n, dtype=torch.int64, device=dev)
    target = torch.zeros(2 * n, dtype=torch.int64, device=dev)
    for o in range(2):
        h, lw, f, r = _orient(hi, lo, fh, rh, k, o)
        first = km.first_base(h, k)
        cnt = torch.zeros(n, dtype=torch.int64, device=dev)
        tgt = torch.full((n,), -1, dtype=torch.int64, device=dev)
        for x in range(4):
            nh, nl = km.shift_in(h, lw, x, k)
            nf, nr = km.succ_hash(f, r, first, x, k, bits)
            e = lookup(keys, counts, km.key_of(nf, nr, key_bits)) \
                >= abundance_min
            ch, cl, flip = km.canonical(nh, nl, k)
            srow = km.find_rows(sh, sl, ch, cl)
            row = torch.where(srow >= 0, row_of_sorted[srow.clamp(min=0)],
                              srow)
            t = torch.where(row >= 0, 2 * row + flip.long(), row)
            cnt += e.long()
            tgt = torch.where(e, t, tgt)
        nsucc[o::2] = cnt
        target[o::2] = tgt
    a = torch.arange(2 * n, device=dev)
    ok = (nsucc == 1) & (target >= 0)
    ok &= nsucc[(target ^ 1).clamp(0, 2 * n - 1)] == 1
    ok &= (target != a) & (target != (a ^ 1))
    node_counts = lookup(keys, counts, km.key_of(fh, rh, key_bits))
    return torch.where(ok, target, torch.full_like(target, -1)), node_counts


def contract(chain_next: torch.Tensor):
    """(head, dist) of every oriented node along the chains, by pointer
    jumping; a cycle is cut at its least oriented index."""
    M = chain_next.numel()
    dev = chain_next.device
    idx = torch.arange(M, device=dev)
    rounds = max(M, 2).bit_length() + 1
    prev = torch.full((M,), -1, dtype=torch.int64, device=dev)
    src = chain_next >= 0
    prev[chain_next[src]] = idx[src]
    has_prev = prev >= 0
    par0 = torch.where(has_prev, prev, idx)
    par, reached = par0, ~has_prev
    for _ in range(rounds):
        reached = reached | reached[par]
        par = par[par]
    par, least = par0, idx
    for _ in range(rounds):
        least = torch.minimum(least, least[par])
        par = par[par]
    has_prev = has_prev & ~(~reached & (least == idx))
    par = torch.where(has_prev, prev, idx)
    dist = has_prev.long()
    for _ in range(rounds):
        dist = dist + dist[par]
        par = par[par]
    return par, dist


def _bases(h: int, lo: int, k: int) -> list:
    v = (h << 64) | (lo & ((1 << 64) - 1))
    return [(v >> (2 * (k - 1 - i))) & 3 for i in range(k)]


def _kmer_int(seq: np.ndarray) -> int:
    v = 0
    for b in seq:
        v = (v << 2) | int(b)
    return v


def _rc(seq: np.ndarray) -> np.ndarray:
    return (3 - seq[::-1]).astype(np.uint8)


def assemble(reads, sizing: dict, keys, counts, bits=64):
    """The unitig graph of the reads against the spectrum (keys, counts)."""
    k, key_bits = sizing["k"], sizing["key_bits"]
    amin = sizing["abundance_min"]
    smin, smax = sizing["solid_min"], sizing["solid_max"]
    hi, lo, fh, rh, mid = collect(reads, k, key_bits, keys, counts, amin,
                                  bits)
    n_collected = mid.numel()
    hi, lo, fh, rh, sh, sl = close(hi, lo, fh, rh, k, key_bits, keys,
                                   counts, amin, bits)
    chain_next, node_counts = chain_edges(hi, lo, fh, rh, sh, sl, k,
                                          key_bits, keys, counts, amin,
                                          bits)
    head, dist = contract(chain_next)
    n = hi.numel()
    dev = hi.device
    # oriented words of every oriented node a = 2 x node + o
    rhi, rlo = km.revcomp(hi, lo, k)
    oh = torch.stack([hi, rhi], 1).reshape(-1)
    ol = torch.stack([lo, rlo], 1).reshape(-1)
    # members by (head, dist): one segment a path
    order = torch.argsort(dist, stable=True)
    order = order[torch.argsort(head[order], stable=True)]
    h_sorted = head[order]
    start = torch.ones_like(h_sorted, dtype=torch.bool)
    start[1:] = h_sorted[1:] != h_sorted[:-1]
    starts = torch.nonzero(start).reshape(-1)
    ends = torch.cat([starts[1:], torch.tensor([order.numel()],
                                               device=dev)]) - 1
    heads = order[starts]
    tails = order[ends]
    mirror = tails ^ 1
    keep = ~km.ulex_less(oh[mirror], ol[mirror], oh[heads], ol[heads])
    lo_pair = torch.minimum(heads, mirror)
    hi_pair = torch.maximum(heads, mirror)
    pair = lo_pair * (2 * n) + hi_pair
    kept = torch.nonzero(keep).reshape(-1)
    _, first_of = np.unique(pair[kept].cpu().numpy(), return_index=True)
    kept = kept[torch.from_numpy(np.sort(first_of)).to(dev)]

    order_np = order.cpu().numpy()
    starts_np = starts.cpu().numpy()
    ends_np = ends.cpu().numpy()
    ncount = node_counts.cpu().numpy()
    seed = np.zeros(n, bool)
    seed[:n_collected] = mid.cpu().numpy() != 0
    seed &= (ncount >= smin) & (ncount <= smax)
    last_b = torch.stack([km.last_base(lo), 3 - km.first_base(hi, k)],
                         1).reshape(-1).cpu().numpy().astype(np.uint8)
    OH = oh.cpu().numpy().astype(np.uint64)
    OL = ol.cpu().numpy().astype(np.uint64)
    uni = []
    for s in kept.cpu().numpy():
        mem = order_np[starts_np[s]:ends_np[s] + 1]
        a0 = int(mem[0])
        first = np.array(_bases(int(OH[a0]), int(OL[a0]), k), np.uint8)
        seq = np.concatenate([first, last_b[mem[1:]]]).astype(np.uint8)
        c = np.sort(ncount[mem >> 1])
        m = len(c)
        med = int(c[m // 2]) if m % 2 else int((int(c[m // 2 - 1])
                                                + int(c[m // 2])) // 2)
        uni.append({"seq": seq, "med": med,
                    "mean": float(np.sum(ncount[mem >> 1])) / m,
                    "seed": bool(seed[mem >> 1].any())})
    return _link_and_filter(uni, k)


def _link_and_filter(uni: list, k: int) -> list:
    """Links between unitigs, then the seeded components."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    table = {}
    for i, u in enumerate(uni):
        table[_kmer_int(_rc(u["seq"][-k:]))] = -(i + 1)
        table[_kmer_int(u["seq"][:k])] = i + 1
    mask = (1 << (2 * k)) - 1
    edges_u, edges_v = [], []
    for i, u in enumerate(uni):
        tail = _kmer_int(u["seq"][-k:])
        rfirst = _kmer_int(_rc(u["seq"][:k]))
        top = 2 * (k - 1)
        after = [table.get(((tail << 2) & mask) | x, 0) for x in range(4)]
        before = [table.get(((rfirst << 2) & mask) | x, 0)
                  for x in (3, 2, 1, 0)]
        sib = [table.get((tail & ~(3 << top)) | (x << top), 0)
               for x in range(4)]
        sib += [table.get((rfirst & ~(3 << top)) | (x << top), 0)
                for x in range(4)]
        u["after"] = [t for t in after if t]
        u["before"] = [t for t in before if t]
        for t in after + before + sib:
            if t:
                edges_u.append(i)
                edges_v.append(abs(t) - 1)
    n = len(uni)
    if n == 0:
        return []
    g = coo_matrix((np.ones(len(edges_u), np.int8), (edges_u, edges_v)),
                   shape=(n, n))
    _, lab = connected_components(g, directed=False)
    seeded = set(int(lab[i]) for i, u in enumerate(uni) if u["seed"])
    keep = [i for i in range(n) if int(lab[i]) in seeded]
    new_id = {old: new for new, old in enumerate(keep)}

    def remap(ts):
        return [(1 if t > 0 else -1) * (new_id[abs(t) - 1] + 1) for t in ts
                if abs(t) - 1 in new_id]

    out = []
    for i in keep:
        u = uni[i]
        out.append({"seq": u["seq"], "med": u["med"], "mean": u["mean"],
                    "after": remap(u["after"]),
                    "before": remap(u["before"])})
    return out
