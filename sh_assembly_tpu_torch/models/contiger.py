"""Contiger — unitig graph construction, on a PyTorch device.

Counterpart of ``sh_assembly_tpu/models/contiger.py``, with the same stages
and the same output (``unitigs.fa`` byte-identical):

  A. node enumeration: stream read batches, stage every N-free window's
     canonical packed k-mer and hash key into a pending buffer; at each
     flush sort it by key, count it against the spectrum (kernel K2,
     ``ops/join_cuda``), keep the solid ones, and fold them into the sorted
     node store (kernel K3, ``ops/merge128_cuda``, at every k up to 63:
     the port keeps the seed flag in its own tensor, so the TPU kernel's
     k <= 62 bound does not apply).
  B. phantom closure: successor and suffix-sibling probes whose hash key
     is counted but whose k-mer is not a node join the node set, round by
     round over the frontier, to the fixpoint (the probes through kernel
     K8, their counts through K2, their node join through K7: one table,
     ``ops/node_join_cuda.NodeTable``, built from round 1's padded store,
     each round's phantoms appended to it).
  C. edge probing: the 8 successor probes of both orientations of every
     node (kernel K8, ``ops/probe_cuda``; a probe of the closure's K7
     table, whose store the graph's is, for the successor indices, one K2
     count join for the 9N counts) give out-degrees and contractible
     chain edges.
  D. contraction where the chain forest lies: kernel K9
     (``ops/contract_cuda``: the ranking, the reverse complements and the
     mirror keep rule) and kernel K10 (``ops/members_cuda``: the kept
     paths' members in order), each on CUDA tensors, their plain twins on
     any other; then the vectorised host assembly: sequences, medians,
     links, the solid-seed component filter, FASTA.  Copied from the JAX
     package; every device array reaches it as numpy uint64 through
     ``bits.to_u64_np``, because the assembly compares k-mer words
     unsigned.

The node order decides the unitig numbering in ``unitigs.fa``: phantoms
are appended in the order the closure finds them, and a round whose output
is truncated to the frontier's padded extent re-probes the whole store.
So the pad extents (``padded`` and ``_frontier_pad``) are kept exactly,
though the port compiles nothing per shape.

Node k-mers are (hi, lo) int64 pairs (``ops/kmerpack``), (-1, -1) the
sentinel; seed flags are uint8 (1 = some read's middle k-mer).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, NamedTuple

import numpy as np
import torch

from .. import config as cfg
from ..io import fastq
from ..ops import bits, contract_cuda, kmerpack as kp, kmerpack_np as kpn, \
    members_cuda, merge128_cuda, node_join_cuda, packio, probe_cuda, \
    spectrum as sp, stage_cuda
from ..utils import dna, profiling
from ..utils.logging import log

NODE_SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)
SENT = bits.SENTINEL


# --------------------------------------------------------------------------
# Stage A: node enumeration
# --------------------------------------------------------------------------

@dataclass
class _Pending:
    """Staged candidate windows; only the first ``n`` entries are live."""

    hi: torch.Tensor  # int64[cap] canonical packed k-mer
    lo: torch.Tensor  # int64[cap]
    key: torch.Tensor  # int64[cap] spectrum hash key, -1 = invalid window
    seed: torch.Tensor  # uint8[cap] 1 = read-middle window
    n: int = 0

    @classmethod
    def make(cls, cap: int, device) -> "_Pending":
        def full():
            return torch.full((cap,), SENT, dtype=torch.int64, device=device)

        return cls(full(), full(), full(),
                   torch.zeros(cap, dtype=torch.uint8, device=device))


@dataclass
class _NodeStore:
    """Sorted node store: ``n`` live entries, sentinel tail."""

    hi: torch.Tensor  # int64[node_cap]
    lo: torch.Tensor  # int64[node_cap]
    seed: torch.Tensor  # uint8[node_cap]
    n: int = 0


def _stage_super(pend: _Pending, packed, nmask, lengths, seed_cols, k: int,
                 key_bits: int, L: int) -> None:
    """Stage one superstep of read rows into the pending buffer.

    Every valid N-free window's canonical packed k-mer and hash key are
    appended raw at offset ``pend.n`` (invalid lanes as sentinels), written
    in place by ``stage_cuda.stage_windows`` (kernel K6 on CUDA tensors).
    Dedup, the count filter and the store fold wait for _flush_pending.
    seed_cols[r] marks the column of the source read's middle k-mer (-1 =
    none): those windows carry a seed flag.
    """
    if packed.shape[-1] * 4 != L:
        raise ValueError(f"packed rows of {packed.shape[-1] * 4} bases, "
                         f"L = {L}")
    pend.n += stage_cuda.stage_windows(
        pend.hi, pend.lo, pend.key, pend.seed, pend.n, packed, nmask,
        lengths, seed_cols, k, key_bits)


def _flush_pending(spec: sp.Spectrum, store: _NodeStore, pend: _Pending,
                   key_bits: int, abundance_min: int) -> int:
    """Count-filter the live pending candidates, fold the solid ones into
    the node store (updated in place), empty the buffer; returns the
    fold's n_live, which may exceed the store's capacity.

    The buffer is sorted by key (stable) so K2 can answer it; the solid
    survivors are sorted by (hi, lo, inverted seed flag), so each k-mer's
    seeded copy comes first and the keep-first fold ORs the seed flags.
    """
    n = pend.n
    order = torch.sort(bits.flip(pend.key[:n]), stable=True).indices
    counts = sp.query_join_sorted(spec, pend.key[:n][order], key_bits)
    solid = counts >= abundance_min
    chi = torch.where(solid, pend.hi[:n][order], SENT)
    clo = torch.where(solid, pend.lo[:n][order], SENT)
    cnf = torch.where(solid, 1 - pend.seed[:n][order], 1).to(torch.uint8)
    perm = kp.sort_pairs(chi, clo, cnf)
    cap = store.hi.shape[0]
    o_hi, o_lo, o_nf, n_live = merge128_cuda.merge128(
        store.hi, store.lo, 1 - store.seed, store.n,
        chi[perm], clo[perm], cnf[perm], cap)
    n_live = int(n_live)  # one host sync per flush
    store.hi, store.lo, store.seed = o_hi, o_lo, 1 - o_nf
    store.n = min(n_live, cap)
    pend.n = 0
    return n_live


def collect_nodes(spec: sp.Spectrum, batches: Iterable[fastq.Batch], k: int,
                  key_bits: int, abundance_min: int,
                  super_batch: int = 8, node_cap: int | None = None,
                  pend_supers: int = 8):
    """Distinct solid canonical k-mers over all read batches -> sorted
    (hi, lo, seed) tensors on the spectrum's device (seed: uint8, 1 iff the
    k-mer is some read's middle k-mer; None if no batch carried seed
    metadata, and the caller falls back to the component-contains-solid
    rule).

    Supersteps stage candidate windows into a pending buffer sized for
    ~pend_supers supersteps; the count filter and the node-store fold run
    once per buffer fill.  The buffer's sizing follows the JAX package's
    exactly, including query_join's two batch budgets.
    """
    dev = spec.store.device
    if node_cap is None:
        # nodes are a subset of distinct solid hash keys, plus rare extra
        # k-mers aliased by hash collisions: ndistinct with 1/16 slack
        nd = max(int(spec.ndistinct), 1024)
        node_cap = 1 << int(np.ceil(np.log2(nd + nd // 16 + 1024)))
    p = sp.payload_bits(key_bits)
    run_bits = 63 - (p - 1)
    max_by_runid = max((1 << run_bits) - spec.capacity - 1, 1 << 10)
    max_rows_total = min((1 << (p - 1)) // 2, max_by_runid)

    store = _NodeStore(
        hi=torch.full((node_cap,), SENT, dtype=torch.int64, device=dev),
        lo=torch.full((node_cap,), SENT, dtype=torch.int64, device=dev),
        seed=torch.zeros(node_cap, dtype=torch.uint8, device=dev))
    # running peak: a mid-run flush can overflow (truncating the largest
    # keys) and later flushes can land back at or below cap, so the final
    # count alone cannot prove no truncation happened
    n_peak = 0
    pend: _Pending | None = None
    pend_cap = 0
    saw_seed_meta = False

    stack_p, stack_m, stack_l, stack_s = [], [], [], []
    rows = 0
    Lp = None

    def flush_pending():
        nonlocal n_peak
        n_peak = max(n_peak, _flush_pending(spec, store, pend, key_bits,
                                            abundance_min))

    def to_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def stage():
        nonlocal pend, pend_cap
        nonlocal stack_p, stack_m, stack_l, stack_s, rows
        if not stack_p:
            return
        packed = np.concatenate(stack_p, axis=0)
        nmask = np.concatenate(stack_m, axis=0)
        lens = np.concatenate(stack_l, axis=0)
        seedc = np.concatenate(stack_s, axis=0)
        nq = packed.shape[0] * (Lp - k + 1)
        if pend is not None and nq > pend_cap:
            # a later superstep outgrew the first one's sizing: drain and
            # reallocate (only mixed batch_rows streams hit this)
            flush_pending()
            pend = None
        if pend is None:
            pend_cap = 1 << int(np.ceil(np.log2(max(nq, 1024))))
            while pend_cap < pend_supers * nq and pend_cap * 2 <= \
                    max_rows_total:
                pend_cap *= 2
            pend = _Pending.make(pend_cap, dev)
        # flush BEFORE staging when this superstep would not fit
        if pend.n + nq > pend_cap:
            flush_pending()
        _stage_super(pend, to_dev(packed), to_dev(nmask),
                     to_dev(lens.astype(np.int32)), to_dev(seedc), k,
                     key_bits, Lp)
        stack_p, stack_m, stack_l, stack_s = [], [], [], []
        rows = 0

    it = iter(batches)
    while True:
        # the wait on the stream (in the pipeline, the FASTQ's decode)
        with profiling.phase("contiger:collect nodes.wait", sync=False):
            b = next(it, None)
        if b is None:
            break
        if isinstance(b, fastq.PackedBatch):
            Lp_b = b.row_len
            p_, m_ = b.packed, b.nmask
        else:
            codes = b.codes
            L = codes.shape[1]
            Lp_b = (L + 7) // 8 * 8
            if Lp_b != L:
                codes = np.pad(codes, ((0, 0), (0, Lp_b - L)),
                               constant_values=5)
            p_, m_ = packio.pack_np(codes)
        if Lp is None:
            Lp = Lp_b
        if Lp_b != Lp:
            raise ValueError("mixed batch read lengths")
        W = Lp - k + 1
        batch_rows = p_.shape[0]
        if batch_rows * W > max_rows_total:
            raise ValueError(
                f"one batch's {batch_rows * W} windows exceed the query_join "
                f"budget {max_rows_total}; shrink reads_per_batch")
        # stage BEFORE appending when the stacked windows would blow the
        # query budget (appending first could exceed it by one batch)
        if rows and (rows + batch_rows) * W > max_rows_total:
            stage()
        stack_p.append(p_)
        stack_m.append(m_)
        stack_l.append(b.lengths)
        if b.seed_col is not None:
            saw_seed_meta = True
            stack_s.append(np.asarray(b.seed_col, np.int32))
        else:
            stack_s.append(np.full(batch_rows, -1, np.int32))
        rows += batch_rows
        if rows >= super_batch * batch_rows:
            stage()
    stage()
    if pend is not None:
        flush_pending()

    if n_peak >= node_cap:
        raise RuntimeError(
            f"node store overflow: {n_peak} distinct solid k-mers reached cap "
            f"{node_cap}; pass a larger node_cap")
    n = store.n
    return (store.hi[:n], store.lo[:n],
            store.seed[:n] if saw_seed_meta else None)


# --------------------------------------------------------------------------
# Stages B+C: phantom closure and graph probes
# --------------------------------------------------------------------------

def phantom_candidates(spec: sp.Spectrum, store_hi, store_lo, hi, lo,
                       k: int, key_bits: int, abundance_min: int,
                       table: node_join_cuda.NodeTable | None = None):
    """Successor and sibling k-mers of the FRONTIER (hi, lo) that pass the
    count filter but are not in the node store (store_hi, store_lo).

    The reference probes neighbours by hash count only, so a probe whose
    key aliases a counted key spawns a k-mer that appears in no read; these
    "phantom" nodes join the node set.

    Returns (ph_hi[F], ph_lo[F], n_new, n_found): the distinct phantoms in
    sorted order, truncated and sentinel-padded to the frontier size F;
    n_new = min(n_found, F) and n_found the true total (host ints), so the
    caller can detect truncation.  ``table``: a node table (kernel K7)
    that holds the store (store_hi, store_lo) itself, probed in place of a
    one-shot ``join2``.
    """
    N = hi.shape[0]
    dev = hi.device
    valid = ~((hi == SENT) & (lo == SENT))
    # the 16 probes a node (kernel K8 on CUDA tensors), one K2 count join
    # for their keys and one node join for their indices (K7); the count
    # join first: its sort is the closure's peak of device memory, which
    # the join's answers need not add to
    keys, probe_hi, probe_lo, _ = probe_cuda.node_probes(
        hi, lo, k, key_bits, "closure")
    P = keys.shape[0]  # 16 probes per node
    all_hi, all_lo = probe_hi.reshape(-1), probe_lo.reshape(-1)
    counts = sp.query_join_auto(spec, keys, key_bits).reshape(P, N)
    del keys
    all_j = _node_join(store_hi, store_lo, all_hi, all_lo, table) \
        .reshape(P, N)
    ph = ((counts >= abundance_min) & (all_j < 0) & valid[None, :]) \
        .reshape(-1)
    # a probe k-mer is never the sentinel (its low bits are zero for
    # k <= 63), so compacting before the sort gives the JAX package's
    # sort-then-drop-sentinels result
    ph_hi, ph_lo = all_hi[ph], all_lo[ph]
    perm = kp.sort_pairs(ph_hi, ph_lo)
    sh, sl = ph_hi[perm], ph_lo[perm]
    first = torch.ones(sh.shape, dtype=torch.bool, device=dev)
    first[1:] = (sh[1:] != sh[:-1]) | (sl[1:] != sl[:-1])
    u_hi, u_lo = sh[first], sl[first]
    n_found = u_hi.numel()
    n_new = min(n_found, N)
    oh = torch.full((N,), SENT, dtype=torch.int64, device=dev)
    ol = torch.full((N,), SENT, dtype=torch.int64, device=dev)
    oh[:n_new], ol[:n_new] = u_hi[:n_new], u_lo[:n_new]
    return oh, ol, n_new, n_found


def _node_join(store_hi, store_lo, qhi, qlo, table):
    """The queries' store rows: a probe of ``table``, which must hold the
    store itself, or a one-shot ``join2``."""
    if table is None:
        return kp.join2(store_hi, store_lo, qhi, qlo)
    if not table.holds(store_hi, store_lo):
        raise ValueError("the node table holds another store")
    return table.probe(qhi, qlo)


def _padded(h, l, at_least=1024):
    """(h, l) padded with sentinel rows to the JAX package's power-of-two
    extent (at least ``at_least`` and 2^10 rows)."""
    n = h.shape[0]
    Np = 1 << max(int(np.ceil(np.log2(max(n, at_least)))), 10)
    hp = torch.full((Np,), SENT, dtype=torch.int64, device=h.device)
    lp = torch.full((Np,), SENT, dtype=torch.int64, device=h.device)
    hp[:n] = h
    lp[:n] = l
    return hp, lp


def _grow(table: node_join_cuda.NodeTable, hi, lo, n: int) -> None:
    """Put rows (hi, lo) after the n real rows of the table's padded store:
    appended in place of pad rows while one pad row is left to answer the
    sentinel, else padded anew to the extent of n + m rows and built."""
    if n + hi.shape[0] < table.hi.shape[0]:
        table.append(hi, lo, n)
    else:
        table.build(*_padded(torch.cat([table.hi[:n], hi]),
                             torch.cat([table.lo[:n], lo])),
                    n + hi.shape[0])


def _frontier_pad(n_frontier: int, store_pad: int) -> int:
    """Frontier pad extent: the smallest rung of a fixed ladder that holds
    the frontier, capped at the store's own pad extent.  Kept exactly as
    in the JAX package: phantom_candidates truncates its output to this
    extent, which decides when a round re-probes the whole store and so
    the order phantoms are appended in (and the unitig numbering)."""
    for cand in (1 << 14, 1 << 22):
        if n_frontier <= cand <= store_pad:
            return cand
    return store_pad


def close_over_phantoms(spec: sp.Spectrum, hi, lo, k: int, key_bits: int,
                        abundance_min: int, max_rounds: int = 8,
                        table: node_join_cuda.NodeTable | None = None):
    """Close the node set (hi, lo tensors) over phantom successors (see
    phantom_candidates).  Rounds after the first probe only the frontier
    (last round's additions).

    Each round probes the store padded as the JAX package pads it.  One
    node table (kernel K7) is built from round 1's padded store; a later
    round inserts only the phantoms appended in place of pad rows, and
    pads and builds anew only when the store fills or outgrows its padded
    extent (no pad row would be left to answer the sentinel).  Pass an
    empty ``table`` to keep it: it then holds the last round's padded
    store, which is the graph's (``assemble_unitigs_arrays``).

    Returns (hi, lo, n_phantoms); appended phantoms keep the closure's
    discovery order.  Raises RuntimeError when the closure has not
    converged after max_rounds rounds (the node set would silently diverge
    from the reference candidate semantics; raise key_bits).
    """
    table = node_join_cuda.NodeTable() if table is None else table
    n = hi.shape[0]
    table.build(*_padded(hi, lo), n)
    total_new = 0
    f_hi, f_lo = hi, lo  # round-1 frontier = everything
    for _ in range(max_rounds):
        fh, fl = _padded(f_hi, f_lo,
                         _frontier_pad(f_hi.shape[0], table.hi.shape[0]))
        ph_h, ph_l, n_new, n_found = phantom_candidates(
            spec, table.hi, table.lo, fh, fl, k, key_bits, abundance_min,
            table)
        del fh, fl
        if n_new == 0:
            break
        f_hi, f_lo = ph_h[:n_new], ph_l[:n_new]
        _grow(table, f_hi, f_lo, n)
        n += n_new
        total_new += n_new
        if n_found > n_new:
            # output was truncated to the frontier extent: re-probe with
            # the full store as the frontier so the dropped candidates are
            # rediscovered (they are still absent from the store)
            f_hi, f_lo = table.hi[:n], table.lo[:n]
    else:
        raise RuntimeError(
            f"phantom closure not converged after {max_rounds} rounds "
            f"({total_new} phantom nodes added): the node set would "
            f"silently diverge from reference candidate semantics; raise "
            f"key_bits (hash collisions are pathologically dense) or "
            f"max_rounds")
    if total_new:
        log(f"[Contiger] {total_new} phantom hash-collision nodes added "
            f"(reference candidate semantics)")
    return table.hi[:n], table.lo[:n], total_new


def build_oriented_graph(spec: sp.Spectrum, hi, lo, k: int, key_bits: int,
                         abundance_min: int,
                         table: node_join_cuda.NodeTable | None = None):
    """Probe successors for both orientations of every node.  ``table``: a
    node table (kernel K7) that holds (hi, lo) itself, probed in place of
    a one-shot ``join2``.

    Returns (nsucc[2N], chain_next[2N], node_counts[N]) int32 tensors.
    Oriented index a = 2*i + o with o=0 the canonical orientation, o=1 its
    reverse complement.  chain_next[a] = oriented successor index when the
    a->succ edge is a contractible chain edge, else -1.
    """
    N = hi.shape[0]
    dev = hi.device
    # padding entries (both words all-ones) never equal a left-aligned real
    # k-mer for k <= 63
    valid = ~((hi == SENT) & (lo == SENT))

    # the 8 successor probes a node and its own key (kernel K8 on CUDA
    # tensors); one node join (K7) resolves all 8N successor indices, one K2
    # count join all 9N counts
    keys, succ_hi, succ_lo, succ_flip = probe_cuda.node_probes(
        hi, lo, k, key_bits, "graph")
    all_j = _node_join(hi, lo, succ_hi.reshape(-1), succ_lo.reshape(-1),
                       table).reshape(8, N)
    del succ_hi, succ_lo
    all_counts = sp.query_join_auto(spec, keys, key_bits).reshape(9, N)
    del keys
    node_counts = all_counts[0]

    nsucc, succ_idx, succ_orient = [], [], []
    for o in range(2):
        ecount = torch.zeros(N, dtype=torch.int32, device=dev)
        uj = torch.zeros(N, dtype=torch.int32, device=dev)
        up = torch.zeros(N, dtype=torch.int32, device=dev)
        for X in range(4):
            e = (all_counts[1 + o * 4 + X] >= abundance_min) & valid
            ecount += e.int()
            # the unique successor (when ecount == 1)
            uj += torch.where(e, all_j[o * 4 + X], 0)
            up += torch.where(e, succ_flip[o * 4 + X], 0)
        nsucc.append(ecount)
        succ_idx.append(uj)
        succ_orient.append(up)

    # interleave to oriented arrays [2N]: a = 2*i + o
    nsucc_a = torch.stack(nsucc, dim=1).reshape(-1)
    sj = torch.stack(succ_idx, dim=1).reshape(-1)
    sp_ = torch.stack(succ_orient, dim=1).reshape(-1)

    target = torch.where(sj >= 0, 2 * sj + sp_, -1).int()
    flip_target = torch.where(sj >= 0, 2 * sj + (1 - sp_), -1)
    # where nsucc != 1, sj sums several successors and may point past the
    # end: clamp the gather (as XLA does); ok is false there anyway
    ft = flip_target.clamp(0, 2 * N - 1).long()
    ok = (nsucc_a == 1) & (target >= 0) & (nsucc_a[ft] == 1)
    a_idx = torch.arange(2 * N, dtype=torch.int32, device=dev)
    # no self-chain (homopolymer 1-cycles are cycles) and no immediate
    # hairpin a -> flip(a)
    ok = ok & (target != a_idx) & (target != (a_idx ^ 1))
    chain_next = torch.where(ok, target, -1).int()
    return nsucc_a, chain_next, node_counts


# --------------------------------------------------------------------------
# Host assembly: vectorized sequences, medians, links, FASTA
# --------------------------------------------------------------------------

def median_int(values: np.ndarray) -> int:
    """Reference median (Utility.cpp:27-39), truncated to int on store
    (Contig.median_abundance is an int, Utility.h:28-55)."""
    n = len(values)
    if n == 0:
        return 0
    v = np.sort(values)
    if n % 2 == 0:
        return int((int(v[n // 2 - 1]) + int(v[n // 2])) / 2.0)
    return int(v[n // 2])


def check_solid_cap(key_bits: int, solid_abundance_max: int) -> None:
    """Spectrum counts saturate at count_cap(key_bits); once the cap is at
    or below solid_abundance_max, a saturated count can stand for a true
    count above the -X threshold and the seed filter silently diverges
    from the reference (contig_assembly.cpp:2082).  Refuse to guess."""
    cap = sp.count_cap(key_bits)
    if solid_abundance_max >= cap:
        raise ValueError(
            f"count saturation cap {cap} (key_bits={key_bits}) is not above "
            f"solid_abundance_max={solid_abundance_max}: saturated counts "
            f"would pass the -X seed filter; lower -X below the cap")


@dataclass
class Unitig:
    seq: str
    median_abundance: int
    # mean k-mer abundance — Minia/gatb-core's RCTC coverage metric
    # (Simplifications.cpp uses unitig MEAN abundance, not median); carried
    # in-memory for the in-framework simplification stage.  The FASTA
    # km:f: field stays the reference's median for byte parity
    # (contig_assembly.cpp:610-626).
    mean_abundance: float = 0.0


@dataclass
class ArrayUnitigs:
    """Final unitig graph as flat numpy arrays (SoA) — no per-unitig Python
    objects, so assembly and FASTA dump stay O(n) vector ops at the 1e7+
    unitig scale the reference handles (contig_assembly.cpp:277-629).

    Sequence of unitig i = seq_codes[offsets[i]:offsets[i+1]] (2-bit codes);
    links use the reference's signed-id convention and CSR layout:
    after_val[after_ptr[i]:after_ptr[i+1]].
    """

    k: int
    seq_codes: np.ndarray  # uint8[total] base codes 0..3
    offsets: np.ndarray  # int64[n+1]
    med: np.ndarray  # int64[n] median k-mer abundance
    after_ptr: np.ndarray  # int64[n+1]
    after_val: np.ndarray  # int64[] signed ids (+-(id+1))
    before_ptr: np.ndarray  # int64[n+1]
    before_val: np.ndarray  # int64[]
    n_palindromes: int = 0
    mean: np.ndarray | None = None  # float64[n] mean k-mer abundance

    @property
    def n(self) -> int:
        return len(self.med)

    @classmethod
    def empty(cls, k: int) -> "ArrayUnitigs":
        z = np.zeros(0, np.int64)
        p = np.zeros(1, np.int64)
        return cls(k=k, seq_codes=np.zeros(0, np.uint8), offsets=p, med=z,
                   after_ptr=p, after_val=z, before_ptr=p, before_val=z,
                   mean=np.zeros(0, np.float64))

    def seq(self, i: int) -> str:
        return dna.decode(self.seq_codes[self.offsets[i]:self.offsets[i + 1]])

    def to_graph(self) -> "UnitigGraph":
        """Materialize the list-of-objects view (simplification stage /
        tests); O(n) Python-object cost — avoid on huge graphs."""
        ascii_buf = dna._CODE2ASCII[self.seq_codes].tobytes()
        g = UnitigGraph(k=self.k, n_palindromes=self.n_palindromes)
        offs = self.offsets
        for i in range(self.n):
            g.unitigs.append(Unitig(
                seq=ascii_buf[offs[i]:offs[i + 1]].decode(),
                median_abundance=int(self.med[i]),
                mean_abundance=(float(self.mean[i]) if self.mean is not None
                                else float(self.med[i]))))
            g.after.append(
                self.after_val[self.after_ptr[i]:self.after_ptr[i + 1]]
                .tolist())
            g.before.append(
                self.before_val[self.before_ptr[i]:self.before_ptr[i + 1]]
                .tolist())
        return g

    def write_fasta(self, path: str) -> None:
        """Reference dump format (contig_assembly.cpp:600-629), written from
        the arrays in buffered chunks."""
        ascii_buf = dna._CODE2ASCII[self.seq_codes]
        offs, k = self.offsets, self.k
        lens = np.diff(offs)
        kc = self.med * (lens - k + 1)
        with open(path, "wb", buffering=1 << 22) as f:
            for i in range(self.n):
                parts = [f">{i} LN:i:{lens[i]} KC:i:{kc[i]} km:f:{self.med[i]}"]
                for t in self.after_val[self.after_ptr[i]:self.after_ptr[i + 1]]:
                    parts.append(f" L:+:{t - 1}:+" if t > 0
                                 else f" L:+:{-t - 1}:-")
                for t in self.before_val[self.before_ptr[i]:self.before_ptr[i + 1]]:
                    parts.append(f" L:-:{t - 1}:+" if t > 0
                                 else f" L:-:{-t - 1}:-")
                f.write("".join(parts).encode())
                f.write(b"\n")
                f.write(ascii_buf[offs[i]:offs[i + 1]].tobytes())
                f.write(b"\n")


@dataclass
class UnitigGraph:
    k: int
    unitigs: list[Unitig] = field(default_factory=list)
    # signed-id convention of the reference (core/unitig_graph.h:25-50):
    # +.(id+1) = enter unitig id forward; -(id+1) = enter reversed
    after: list[list[int]] = field(default_factory=list)
    before: list[list[int]] = field(default_factory=list)
    n_palindromes: int = 0

    def write_fasta(self, path: str) -> None:
        """Reference dump format (contig_assembly.cpp:600-629)."""
        with open(path, "w") as f:
            for i, u in enumerate(self.unitigs):
                kc = u.median_abundance * (len(u.seq) - self.k + 1)
                f.write(f">{i} LN:i:{len(u.seq)} KC:i:{kc} km:f:{u.median_abundance}")
                for t in self.after[i]:
                    f.write(f" L:+:{t - 1}:+" if t > 0 else f" L:+:{-t - 1}:-")
                for t in self.before[i]:
                    f.write(f" L:-:{t - 1}:+" if t > 0 else f" L:-:{-t - 1}:-")
                f.write(f"\n{u.seq}\n")


def _connected_components(nbr: np.ndarray) -> np.ndarray:
    """Component labels over a dense neighbor matrix nbr[d, n] (self-index
    = no neighbor).

    The unitig link graph contains LONG PATHS (phantom hash-collision
    branches chop one genome walk into thousands of linked unitigs), so
    naive min-label propagation needs O(diameter) rounds.  Use compiled
    linear-time BFS (scipy.sparse.csgraph) with a Shiloach-Vishkin-style
    hook+compress fallback (O(log n) rounds of scatter-min)."""
    n = nbr.shape[1]
    if n == 0:
        return np.zeros(0, np.int64)
    idx = np.broadcast_to(np.arange(n, dtype=np.int64), nbr.shape)
    mask = nbr != idx
    u = idx[mask]
    v = nbr[mask]
    try:
        from scipy.sparse import coo_matrix
        from scipy.sparse.csgraph import connected_components

        g = coo_matrix((np.ones(len(u), np.int8), (u, v)), shape=(n, n))
        _, labels = connected_components(g, directed=False)
        # canonicalize: component id -> minimum member index (deterministic
        # regardless of scipy's internal ordering)
        rep = np.full(labels.max() + 1 if len(labels) else 1, n, np.int64)
        np.minimum.at(rep, labels, np.arange(n, dtype=np.int64))
        return rep[labels]
    except ImportError:  # pragma: no cover
        parent = np.arange(n, dtype=np.int64)
        for _ in range(2 * max(int(np.ceil(np.log2(n + 1))), 1) + 4):
            # hook: roots adopt the minimum parent seen across their edges
            pu, pv = parent[u], parent[v]
            np.minimum.at(parent, pu, pv)
            np.minimum.at(parent, pv, pu)
            # full path compression
            while True:
                pp = parent[parent]
                if np.array_equal(pp, parent):
                    break
                parent = pp
            if np.array_equal(parent[u], parent[v]):
                break
        return parent


def assemble_unitigs_arrays(
    spec: sp.Spectrum,
    batches: Iterable[fastq.Batch],
    params: cfg.ContigerParams,
    key_bits: int,
) -> ArrayUnitigs:
    """Full Contiger stage -> ArrayUnitigs (vectorized host assembly).

    Device stages A-C as documented at module top, on the spectrum's
    device; the host pass then materializes sequences/medians/links with
    numpy segment ops and applies the solid-abundance seed rule: a
    connected component is emitted iff it contains a solid seed k-mer.
    """
    k = params.k
    check_solid_cap(key_bits, params.solid_kmer_abundance_max)
    with profiling.phase("contiger:collect nodes"):
        hi, lo, seed = collect_nodes(spec, batches, k, key_bits,
                                     params.kmer_abundance_min)
    N = hi.shape[0]
    log(f"[Contiger] {N} distinct solid k-mers")
    if N == 0:
        return ArrayUnitigs.empty(k)

    # phantom hash-collision nodes (reference candidate semantics; see
    # phantom_candidates)
    table = node_join_cuda.NodeTable()
    with profiling.phase("contiger:phantom closure"):
        hi, lo, _ = close_over_phantoms(
            spec, hi, lo, k, key_bits, params.kmer_abundance_min,
            table=table)
    N = hi.shape[0]
    is_seed = None
    # the closure's last padded store: the JAX package's power-of-two
    # extent (sentinel nodes are masked inside), which fixes the oriented
    # node numbering; the graph probes the closure's table of it
    hi_pad, lo_pad = table.hi, table.lo
    Np = hi_pad.shape[0]
    if seed is not None:
        # phantoms (appended after the collected nodes) are never seeds
        is_seed = np.zeros(Np, bool)
        is_seed[:len(seed)] = seed.cpu().numpy() != 0
    with profiling.phase("contiger:probe graph"):
        nsucc, chain_next, node_counts = build_oriented_graph(
            spec, hi_pad, lo_pad, k, key_bits, params.kmer_abundance_min,
            table=table)
    del table
    real = np.zeros(Np, bool)
    real[:N] = True
    return finalize_unitigs(hi_pad, lo_pad, real, node_counts, chain_next,
                            params, is_seed=is_seed)


def finalize_unitigs(
    hi: torch.Tensor,
    lo: torch.Tensor,
    real: np.ndarray,
    node_counts: torch.Tensor,
    chain_next: torch.Tensor,
    params: cfg.ContigerParams,
    is_seed: np.ndarray | None = None,
) -> ArrayUnitigs:
    """Contraction + vectorized host assembly.

    hi/lo: padded node k-mers [Np] (sentinel holes allowed anywhere);
    real: bool[Np] live-node mask; chain_next: int32[2*Np] oriented
    successor indices (-1 = none), on the nodes' device.  is_seed:
    bool[Np], True where the node k-mer is some read's middle k-mer; None
    = seed metadata unavailable, fall back to the component-contains-solid
    rule.

    The contraction (K9, ``ops/contract_cuda``) and the members step (K10,
    ``ops/members_cuda``) run where the forest lies: each dispatcher
    launches its kernel on CUDA tensors and its plain twin on any other.
    Nothing crosses but n_bad, read in ``.d2h`` (which so waits for the
    ranking), and the member-ordered arrays, as uint64 k-mer words
    (``bits.to_u64_np``): the rest of the host assembly orders them with
    numpy's unsigned comparisons (``_finalize_host``).
    """
    k = params.k
    contract_cuda.check(chain_next, hi, lo, k)
    with profiling.phase("contiger:contract"):
        with profiling.phase("contiger:contract.walk", sync=False):
            head, dist, tail_of, n_bad = contract_cuda.rank(chain_next)
        with profiling.phase("contiger:contract.revcomp", sync=False):
            rhi, rlo = contract_cuda.revcomp(hi, lo, k)
        with profiling.phase("contiger:contract.keep rule", sync=False):
            keep = contract_cuda.keep(head, tail_of, hi, lo, rhi, rlo)
        with profiling.phase("contiger:contract.d2h", sync=False):
            n_bad = int(n_bad.item())
        if n_bad:
            raise ValueError(f"chain_next: {n_bad} targets out of range or "
                             f"shared by two nodes")
    with profiling.phase("contiger:host assembly"):
        real_t = torch.from_numpy(np.ascontiguousarray(real, dtype=bool)).to(
            hi.device)
        with profiling.phase("contiger:host assembly.members", sync=False):
            mem = _members_to_host(members_cuda.members(
                head, dist, tail_of, keep, hi, lo, rhi, rlo, real_t,
                node_counts, k))
        if mem is None:
            return ArrayUnitigs.empty(k)
        return _finalize_host(mem, params, is_seed)


class _Members(NamedTuple):
    """The members of kept oriented paths in (head, dist) order, as the
    host assembly reads them (numpy)."""

    ai: np.ndarray  # int64 oriented index
    node_i: np.ndarray  # int64 ai >> 1
    ohi: np.ndarray  # uint64 oriented k-mer
    olo: np.ndarray
    lastb: np.ndarray  # uint8 its last base
    counts_mem: np.ndarray  # int64 its node's count
    starts: np.ndarray  # int64 [P] each path's first member
    lens: np.ndarray  # int64 [P]
    tail_pos: np.ndarray  # int64 [P] each path's last member
    head_idx: np.ndarray  # int64 [P] each path's head


def _members_to_host(placed) -> _Members | None:
    """K10's (or its plain twin's) member-ordered tensors -> the arrays
    the rest of the host assembly reads.  None where there is no member."""
    ai_t, ohi, olo, lastb, counts, starts, head_idx = placed
    if ai_t.numel() == 0:
        return None
    ai = ai_t.cpu().numpy().astype(np.int64)
    starts = starts.cpu().numpy().astype(np.int64)
    lens = np.diff(np.r_[starts, len(ai)])
    return _Members(ai, ai >> 1, bits.to_u64_np(ohi), bits.to_u64_np(olo),
                    lastb.cpu().numpy(),
                    counts.cpu().numpy().astype(np.int64), starts, lens,
                    starts + lens - 1,
                    head_idx.cpu().numpy().astype(np.int64))


def _finalize_host(mem: _Members, params, is_seed=None):
    """The host assembly after the members step: mirror dedup, medians,
    links, components, sequences."""
    k = params.k
    ai, node_i, ohi, olo, lastb, counts_mem, starts, lens, tail_pos, \
        head_idx = mem
    P = len(starts)

    # ---- mirror dedup on oriented indices --------------------------------
    with profiling.phase("contiger:host assembly.dedup", sync=False):
        # every unitig appears as two mirror paths; the device keep-rule (head
        # kmer <= mirror head kmer) leaves both only when those kmers are
        # EQUAL, which happens exactly when the unitig is palindromic-headed.
        # The unordered pair {head, flip(tail)} identifies a mirror pair
        # exactly, so dedup on it is collision-free.
        mirror_idx = ai[tail_pos] ^ 1
        pk_lo = np.minimum(head_idx, mirror_idx).astype(np.uint64)
        pk_hi = np.maximum(head_idx, mirror_idx).astype(np.uint64)
        comb = (pk_lo << np.uint64(32)) | pk_hi
        _, first_occ = np.unique(comb, return_index=True)
        sel = np.zeros(P, bool)
        sel[first_occ] = True

    # ---- per-path medians (reference median, Utility.cpp:27-39) ----------
    with profiling.phase("contiger:host assembly.medians", sync=False):
        seg_id = np.repeat(np.arange(P, dtype=np.int64), lens)
        ordm = np.lexsort((counts_mem, seg_id))
        sc = counts_mem[ordm]
        mid = starts + lens // 2
        med = np.where(lens % 2 == 1, sc[mid],
                       (sc[np.maximum(mid - 1, 0)] + sc[mid]) // 2)
        # mean k-mer abundance (gatb RCTC coverage; see Unitig.mean_abundance)
        meanf = np.add.reduceat(counts_mem, starts).astype(np.float64) / lens

        # ---- solid seed flag per path (contig_assembly.cpp:2082) ---------
        # the reference only STARTS traversal from read-MIDDLE k-mers whose
        # count lies in [-x, -X] (contig_assembly.cpp:2068-2082); components
        # unreachable from such a seed are never discovered.  When middle-kmer
        # metadata is unavailable (hand-built batches), fall back to "any solid
        # k-mer seeds" — a superset.
        smin = params.solid_kmer_abundance_min
        smax = params.solid_kmer_abundance_max
        seed_mem = (counts_mem >= smin) & (counts_mem <= smax)
        if is_seed is not None:
            seed_mem = seed_mem & np.asarray(is_seed)[node_i]
        path_seed = np.add.reduceat(seed_mem.astype(np.int64), starts) > 0

        # ---- select deduped paths ----------------------------------------
        pids = np.flatnonzero(sel)
        P2 = len(pids)
        fhi, flo = ohi[starts[pids]], olo[starts[pids]]  # first kmer
        thi, tlo = ohi[tail_pos[pids]], olo[tail_pos[pids]]  # last kmer
        lens2 = lens[pids]
        med2 = med[pids]
        mean2 = meanf[pids]
        seed2 = path_seed[pids]
        starts2 = starts[pids]

    # ---- link table: first kmer -> +(id+1), RC(last kmer) -> -(id+1) -----
    with profiling.phase("contiger:host assembly.links", sync=False):
        # (track_kmer_worker, contig_assembly.cpp:956-1010).  Insertion order
        # mirrors the dict the previous implementation used: for each id, RC
        # then first; the LAST write wins on key collisions (palindromic
        # unitigs collapse to the + entry).
        rthi, rtlo = kpn.revcomp_packed(thi, tlo, k)  # == mirror head kmer
        tab_hi = np.empty(2 * P2, np.uint64)
        tab_lo = np.empty(2 * P2, np.uint64)
        tab_val = np.empty(2 * P2, np.int64)
        ids1 = np.arange(P2, dtype=np.int64) + 1
        tab_hi[0::2], tab_lo[0::2], tab_val[0::2] = rthi, rtlo, -ids1
        tab_hi[1::2], tab_lo[1::2], tab_val[1::2] = fhi, flo, ids1
        ordt = np.lexsort((tab_lo, tab_hi))  # stable: position breaks ties
        th, tl, tv = tab_hi[ordt], tab_lo[ordt], tab_val[ordt]
        last_of_run = np.empty(2 * P2, bool)
        last_of_run[-1] = True
        last_of_run[:-1] = (th[1:] != th[:-1]) | (tl[1:] != tl[:-1])
        key_hi, key_lo, key_val = (
            th[last_of_run], tl[last_of_run], tv[last_of_run])

        # ---- link queries (build_graph_worker, contig_assembly.cpp:1012-1084)
        # after: (last k-1 bases) + X for X in ACGT;
        # before: RC(first k-1 bases) + X for X in TGCA (shift_in_base on the
        # RC'd first kmer reproduces RC(seq[:k-1]) + X exactly).
        rfhi, rflo = kpn.revcomp_packed(fhi, flo, k)
        qa_hi = np.empty((4, P2), np.uint64)
        qa_lo = np.empty((4, P2), np.uint64)
        qb_hi = np.empty((4, P2), np.uint64)
        qb_lo = np.empty((4, P2), np.uint64)
        for X in range(4):
            qa_hi[X], qa_lo[X] = kpn.shift_in_base(thi, tlo, X, k)
        for xi, X in enumerate((3, 2, 1, 0)):
            qb_hi[xi], qb_lo[xi] = kpn.shift_in_base(rfhi, rflo, X, k)
        ja = kpn.join(key_hi, key_lo, qa_hi.reshape(-1), qa_lo.reshape(-1))
        jb = kpn.join(key_hi, key_lo, qb_hi.reshape(-1), qb_lo.reshape(-1))
        av4 = np.where(ja >= 0, key_val[np.maximum(ja, 0)], 0).reshape(4, P2)
        bv4 = np.where(jb >= 0, key_val[np.maximum(jb, 0)], 0).reshape(4, P2)

        # ---- sibling discovery edges (connectivity only, never dumped) ---
        # the reference SPAWNS before-candidates that share a tail junction's
        # (k-1)-suffix (contig_assembly.cpp:3140-3165): a unitig discovered
        # that way belongs to the discovering component even when no k-1
        # overlap link exists (e.g. an isolated phantom sibling).  Probe the 4
        # suffix-siblings of both mirror tails.
        qs_hi = np.empty((8, P2), np.uint64)
        qs_lo = np.empty((8, P2), np.uint64)
        for X in range(4):
            qs_hi[X], qs_lo[X] = kpn.replace_first_base(thi, tlo, X, k)
            qs_hi[4 + X], qs_lo[4 + X] = kpn.replace_first_base(
                rfhi, rflo, X, k)
        jsib = kpn.join(key_hi, key_lo, qs_hi.reshape(-1), qs_lo.reshape(-1))
        sv8 = np.where(jsib >= 0, key_val[np.maximum(jsib, 0)],
                       0).reshape(8, P2)

    # ---- component seed filter (-x/-X semantics) --------------------------
    with profiling.phase("contiger:host assembly.components", sync=False):
        self_idx = np.broadcast_to(np.arange(P2, dtype=np.int64), (4, P2))
        self_idx8 = np.broadcast_to(np.arange(P2, dtype=np.int64), (8, P2))
        nbr = np.vstack([
            np.where(av4 != 0, np.abs(av4) - 1, self_idx),
            np.where(bv4 != 0, np.abs(bv4) - 1, self_idx),
            np.where(sv8 != 0, np.abs(sv8) - 1, self_idx8),
        ])
        lab = _connected_components(nbr)
        comp_seeded = np.zeros(P2, bool)
        if P2:
            comp_seeded[np.unique(lab[seed2])] = True
        keep_u = comp_seeded[lab] if P2 else np.zeros(0, bool)
        n_dropped = P2 - int(keep_u.sum())
        if n_dropped:
            log(f"[Contiger] dropped {n_dropped} unitigs in components with "
                f"no solid seed (count in [{smin}, {smax}])")

        fsel = np.flatnonzero(keep_u)
        F = len(fsel)
        if F == 0:
            return ArrayUnitigs.empty(k)
        new_id = np.full(P2, -1, np.int64)
        new_id[fsel] = np.arange(F)

        def remap_links(v4):
            vals = v4[:, fsel].T  # (F, 4): per-unitig link lists in X order
            mask = vals != 0
            flat = vals[mask]
            flat = np.sign(flat) * (new_id[np.abs(flat) - 1] + 1)
            ptr = np.r_[0, np.cumsum(mask.sum(axis=1))]
            return ptr.astype(np.int64), flat.astype(np.int64)

        after_ptr, after_val = remap_links(av4)
        before_ptr, before_val = remap_links(bv4)

    # ---- sequence materialization ----------------------------------------
    with profiling.phase("contiger:host assembly.sequences", sync=False):
        lens_f = lens2[fsel]
        starts_f = starts2[fsel]
        out_lens = lens_f + k - 1
        offs = np.r_[0, np.cumsum(out_lens)]
        seq_codes = np.empty(offs[-1], np.uint8)
        fhi_f, flo_f = fhi[fsel], flo[fsel]
        for j in range(k):
            seq_codes[offs[:-1] + j] = kpn.base_at(fhi_f, flo_f, j, k)
        m_total = int(lens_f.sum())
        segf = np.repeat(np.arange(F, dtype=np.int64), lens_f)
        within = np.arange(m_total, dtype=np.int64) - np.repeat(
            np.r_[0, np.cumsum(lens_f)[:-1]], lens_f)
        midx = starts_f[segf] + within
        nz = within >= 1
        pos = offs[segf] + (k - 1) + within
        seq_codes[pos[nz]] = lastb[midx[nz]]

        # ---- palindromes: head kmer == mirror head kmer <=> seq == RC(seq)
        pal = (fhi_f == rthi[fsel]) & (flo_f == rtlo[fsel])

        return ArrayUnitigs(
            k=k, seq_codes=seq_codes, offsets=offs.astype(np.int64),
            med=med2[fsel].astype(np.int64),
            after_ptr=after_ptr, after_val=after_val,
            before_ptr=before_ptr, before_val=before_val,
            n_palindromes=int(pal.sum()),
            mean=mean2[fsel])


def assemble_unitigs(
    spec: sp.Spectrum,
    batches: Iterable[fastq.Batch],
    params: cfg.ContigerParams,
    key_bits: int,
) -> UnitigGraph:
    """Object-graph convenience wrapper over assemble_unitigs_arrays."""
    return assemble_unitigs_arrays(spec, batches, params, key_bits).to_graph()
