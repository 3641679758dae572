"""Sorted k-mer spectrum: the counting store, on a PyTorch device.

Counterpart of ``sh_assembly_tpu/ops/spectrum.py`` with the same external
semantics: ``key = min(fh, rh) mod 2^key_bits`` maps to an exact count, in
a flat key-sorted array of packed entries.

Layout (``ops/bits`` conventions):

  packed = key << KSHIFT | traveled << CBITS | min(count, cap)
  KSHIFT = 64 - key_bits, CBITS = min(KSHIFT, 32) - 1

  * ``store``: int64[C], the packed words (the JAX package's ``hi << 32 |
    lo``), key-sorted in unsigned order, sentinel (-1) tail.  8 B/slot.
  * ``buf``: int64[BC] raw keys appended by the hot path, -1 holes for
    invalid windows.  Only ``buf[:n_buf]`` is live: a merge resets
    ``n_buf`` and leaves the old contents behind.

A batch insert is a pure append; when the buffer fills, the buffer prefix
is sorted (``torch.sort``, as the JAX package leaves it to XLA) and folded
into the store by kernel K1 (``ops/merge_cuda``), which segment-reduces
duplicate keys.  The deNoise sweep is K1 with an empty buffer and
``drop_singletons``.  A fold writes into a second buffer, the ``spare``,
and the store it read becomes the next spare, so no fold allocates a store
or rewrites a sentinel tail that is already clean.  A Spectrum from before
a fold stays readable until the fold after it, which overwrites its store.

Off the hot path: the traveled queries mark and read the traveled bit by
binary search, and the set operations (``union``, ``intersect``,
``inner_product``, ``magnitude``) work on merged spectra; ``intersect``
and ``inner_product`` probe through kernel K2 (``ops/join_cuda``).

Counts kept on the host: ``n_main``/``ndistinct`` (read back once per merge)
and ``n_buf`` (advances by whole blocks, known without a sync).  ``nelts``
stays a device scalar so the append path never waits on the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import bits, join_cuda, merge_cuda


@dataclasses.dataclass
class Spectrum:
    """Device-resident k-mer spectrum."""

    store: torch.Tensor  # int64[C] packed entries; -1 = empty slot
    buf: torch.Tensor  # int64[BC] raw keys; only buf[:n_buf] is live
    n_main: int  # live entries in the store
    n_buf: int  # live entries in the buffer
    ndistinct: int  # distinct keys (exact right after a merge)
    nelts: torch.Tensor  # int64[] total occurrences inserted (device)
    # the buffer the next fold writes into (None: the fold makes one);
    # spare[spare_dirty:] is all sentinel
    spare: torch.Tensor | None = None
    spare_dirty: int = 0

    @property
    def capacity(self) -> int:
        return self.store.shape[0]

    @property
    def buf_capacity(self) -> int:
        return self.buf.shape[0]


def make(capacity: int, buf_capacity: int, device="cuda") -> Spectrum:
    return Spectrum(
        store=torch.full((capacity,), bits.SENTINEL, dtype=torch.int64,
                         device=device),
        buf=torch.full((buf_capacity,), bits.SENTINEL, dtype=torch.int64,
                       device=device),
        n_main=0, n_buf=0, ndistinct=0,
        nelts=torch.zeros((), dtype=torch.int64, device=device),
    )


# ---------------------------------------------------------------------------
# Packed-entry format


def payload_bits(key_bits: int) -> int:
    """Bits below the key in the packed entry (= KSHIFT)."""
    p = 64 - key_bits
    if p < 8:
        raise ValueError(f"key_bits {key_bits} leaves no payload room")
    return p


def cbits(key_bits: int) -> int:
    """Width of the count field (traveled bit sits just above it)."""
    return min(payload_bits(key_bits), 32) - 1


def count_cap(key_bits: int) -> int:
    """Saturation cap for packed counts: -2 keeps a saturated payload below
    all-ones (no real entry equals the sentinel); clamped to 2^30."""
    return min((1 << cbits(key_bits)) - 2, 1 << 30)


def unpack_entries_np(packed: np.ndarray, key_bits: int):
    """uint64 packed words -> (keys u64, counts i64, trav u8); sentinel
    slots become (SENTINEL, 0, 0)."""
    kshift = payload_bits(key_bits)
    cb = cbits(key_bits)
    packed = np.asarray(packed, np.uint64)
    sent = packed == np.uint64(0xFFFFFFFFFFFFFFFF)
    keys = np.where(sent, np.uint64(0xFFFFFFFFFFFFFFFF),
                    packed >> np.uint64(kshift))
    counts = np.where(sent, 0,
                      packed & np.uint64((1 << cb) - 1)).astype(np.int64)
    trav = np.where(sent, 0,
                    (packed >> np.uint64(cb)) & np.uint64(1)).astype(np.uint8)
    return keys, counts, trav


# ---------------------------------------------------------------------------
# Hot path: append + merge


def insert(spec: Spectrum, keys: torch.Tensor) -> Spectrum:
    """Append a block of canonical keys (int64, -1 = invalid window).

    Keys must be masked to key_bits.  The block is appended as-is, padding
    included (the merge sorts padding to the tail), so n_buf advances by
    the full block size.  The buffer is written IN PLACE (no copy of the
    1 GiB buffer per batch); the returned Spectrum shares it.
    """
    keys = keys.reshape(-1)
    B = keys.numel()
    if spec.n_buf + B > spec.buf_capacity:
        raise ValueError(f"buffer overflow: {spec.n_buf} + {B} > "
                         f"{spec.buf_capacity}")
    spec.buf[spec.n_buf:spec.n_buf + B] = keys
    n_valid = (keys != bits.SENTINEL).sum()
    return dataclasses.replace(spec, n_buf=spec.n_buf + B,
                               nelts=spec.nelts + n_valid)


def sort_pack_buf(buf: torch.Tensor, key_bits: int) -> torch.Tensor:
    """Raw buffer keys (-1 holes) -> count-0 packed entries, sorted in
    unsigned order with the holes at the tail."""
    p = torch.where(buf == bits.SENTINEL, bits.SENTINEL,
                    buf << payload_bits(key_bits))
    return bits.usort(p)


def _fold(spec: Spectrum, sorted_buf: torch.Tensor, key_bits: int,
          drop_singletons: bool) -> Spectrum:
    n_main = min(spec.n_main, spec.capacity)
    # without a spare the merge makes the second buffer, tail and all
    into = {} if spec.spare is None else dict(out=spec.spare,
                                              out_dirty=spec.spare_dirty)
    out, n_live, n_dropped = merge_cuda.merge_dedup(
        spec.store, sorted_buf, n_main, key_bits, drop_singletons,
        spec.capacity, **into)
    n = int(n_live)  # one host sync per merge
    return Spectrum(
        store=out, buf=spec.buf, n_main=n, n_buf=0, ndistinct=n,
        # each dropped singleton run was one occurrence (the reference's
        # nelts bookkeeping of qf_clean_singleton)
        nelts=spec.nelts - n_dropped,
        # the store just read is sentinel beyond its live entries
        spare=spec.store, spare_dirty=n_main,
    )


def drop_spare(spec: Spectrum) -> Spectrum:
    """The same Spectrum without its spare buffer (frees its memory once no
    earlier Spectrum holds it as its store)."""
    return dataclasses.replace(spec, spare=None, spare_dirty=0)


# Device bytes the buffer sort (``sort_pack_buf``) allocates per key at its
# peak, beyond the buffer: its packed copy, the flipped copy, torch.sort's
# values, indices and scratch.  56.2 at 2^27 keys on an NVIDIA H100 80GB
# HBM3 (chip_smoke.py phase 10b), rounded up.
SORT_BYTES_PER_KEY = 57


def _room_to_sort(spec: Spectrum) -> bool:
    """Whether the buffer sort fits on the spectrum's device beside what is
    allocated now: the device's free memory plus what PyTorch's allocator
    holds unused.  Always true off CUDA."""
    dev = spec.buf.device
    if dev.type != "cuda":
        return True
    free, _ = torch.cuda.mem_get_info(dev)
    idle = torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    return SORT_BYTES_PER_KEY * spec.n_buf <= free + idle


def merge(spec: Spectrum, key_bits: int,
          drop_singletons: bool = False) -> Spectrum:
    """Fold the live buffer prefix into the store (K1).

    With drop_singletons=True runs whose total is 1 are purged (the
    deNoise sweep semantics).  Only ``buf[:n_buf]`` is sorted, so a mostly
    empty buffer costs only its fill.  When the sort would not fit on the
    device beside the spare store, the spare goes first and the fold
    writes into a fresh store: the same result, one store less while the
    buffer is sorted.
    """
    if spec.spare is not None and not _room_to_sort(spec):
        # in place: the caller's reference to spec must let go of it too
        spec.spare, spec.spare_dirty = None, 0
    sb = sort_pack_buf(spec.buf[:spec.n_buf], key_bits)
    return _fold(spec, sb, key_bits, drop_singletons)


def sweep(spec: Spectrum, key_bits: int) -> Spectrum:
    """Singleton deNoise sweep on a merged store (buffer must be empty):
    K1 with an empty buffer and drop_singletons=True."""
    if spec.n_buf:
        raise ValueError("sweep needs a merged store (n_buf == 0)")
    empty = spec.store[:0]
    return _fold(spec, empty, key_bits, drop_singletons=True)


# ---------------------------------------------------------------------------
# Queries (require a merged store)


def _locate(spec: Spectrum, keys: torch.Tensor, key_bits: int):
    """Binary search of raw keys over the whole packed store -> (pos, at,
    found).  A query key compares as ``key << KSHIFT``: real entries carry
    a count >= 1 in their payload, so the left insertion point lands on
    the matching key."""
    kshift = payload_bits(key_bits)
    q = keys.reshape(-1)
    pos = torch.searchsorted(bits.flip(spec.store), bits.flip(q << kshift))
    at = spec.store[pos.clamp_(max=spec.capacity - 1)]
    found = (bits.srl(at, kshift) == q) & (q != bits.SENTINEL) & \
        (at != bits.SENTINEL)
    return pos, at, found


def query(spec: Spectrum, keys: torch.Tensor, key_bits: int) -> torch.Tensor:
    """Batched count lookup by binary search, as the JAX package's
    ``query`` (for tests and tools)."""
    _, at, found = _locate(spec, keys, key_bits)
    counts = at & ((1 << cbits(key_bits)) - 1)
    return torch.where(found, counts, 0).to(torch.int32)


def query_join(spec: Spectrum, keys: torch.Tensor,
               key_bits: int) -> torch.Tensor:
    """Counts for keys in any order (-1 keys answer 0): K2's plain version.

    The two budget checks only mirror the JAX ``query_join``'s API, so
    that both raise on the same batches: the search here packs no run id
    that could overflow.  ``contiger.collect_nodes`` repeats the budgets
    in its own pending sizing and does not call this function.
    """
    keys = keys.reshape(-1)
    Nq = keys.shape[0]
    p = payload_bits(key_bits)
    if Nq >= (1 << (p - 1)):
        raise ValueError("query batch too large for payload bits")
    if (spec.capacity + Nq).bit_length() + (p - 1) > 63:
        raise ValueError("run-id would overflow the scan packing")
    return join_cuda.count_join_plain(spec.store, spec.n_main, keys,
                                      key_bits)


def query_join_sorted(spec: Spectrum, keys: torch.Tensor,
                      key_bits: int) -> torch.Tensor:
    """Counts for ASCENDING keys (-1 tail allowed, answering 0): kernel K2
    on CUDA tensors, its plain version on CPU tensors."""
    return join_cuda.count_join(spec.store, spec.n_main, keys.reshape(-1),
                                key_bits)


def query_join_auto(spec: Spectrum, keys: torch.Tensor,
                    key_bits: int) -> torch.Tensor:
    """Counts for keys in any order through K2: sort the keys, join, and
    scatter the answers back to query order."""
    keys = keys.reshape(-1)
    order = torch.sort(bits.flip(keys)).indices
    out = torch.empty(keys.shape, dtype=torch.int32, device=keys.device)
    out[order] = query_join_sorted(spec, keys[order], key_bits)
    return out


def query_set_traveled(spec: Spectrum, keys: torch.Tensor, key_bits: int):
    """Counts and traveled flags of a batch of keys, marking every found
    key traveled -> (counts int32, was_traveled bool, spec).

    All probes of one batch see the traveled state from before the batch.
    The traveled bit is ORed into the store IN PLACE (every duplicate probe
    writes the same word, the pre-batch entry with the bit set); the
    returned Spectrum is the one passed in.
    """
    pos, at, found = _locate(spec, keys, key_bits)
    cb = cbits(key_bits)
    counts = torch.where(found, at & ((1 << cb) - 1), 0).to(torch.int32)
    was = found & ((at & (1 << cb)) != 0)
    spec.store[pos[found]] = at[found] | (1 << cb)
    return counts, was, spec


def query_is_traveled(spec: Spectrum, keys: torch.Tensor, key_bits: int):
    """The read-only variant -> (counts int32, traveled bool)."""
    _, at, found = _locate(spec, keys, key_bits)
    cb = cbits(key_bits)
    counts = torch.where(found, at & ((1 << cb) - 1), 0).to(torch.int32)
    return counts, found & ((at & (1 << cb)) != 0)


# ---------------------------------------------------------------------------
# Set operations on merged spectra


def _entries(spec: Spectrum, key_bits: int):
    """The store as (keys, counts, traveled) int64 tensors; sentinel slots
    become (-1, 0, 0).  The keys of a merged store ascend, sentinels last."""
    cb = cbits(key_bits)
    sent = spec.store == bits.SENTINEL
    keys = torch.where(sent, bits.SENTINEL,
                       bits.srl(spec.store, payload_bits(key_bits)))
    counts = torch.where(sent, 0, spec.store & ((1 << cb) - 1))
    trav = torch.where(sent, 0, (spec.store >> cb) & 1)
    return keys, counts, trav


def _compacted(words: torch.Tensor, keep: torch.Tensor, spec: Spectrum,
               nelts: torch.Tensor) -> Spectrum:
    """A merged Spectrum of ``words[keep]`` (key-ascending already) in
    spec's capacities.  n_main counts every survivor, also those past the
    capacity (``check_overflow`` applies)."""
    C = spec.capacity
    live = words[keep]
    n = live.numel()
    store = torch.full((C,), bits.SENTINEL, dtype=torch.int64,
                       device=words.device)
    store[:min(n, C)] = live[:C]
    return Spectrum(
        store=store,
        buf=torch.full((spec.buf_capacity,), bits.SENTINEL,
                       dtype=torch.int64, device=words.device),
        n_main=n, n_buf=0, ndistinct=n, nelts=nelts)


def union(a: Spectrum, b: Spectrum, key_bits: int) -> Spectrum:
    """Combine two merged spectra: counts of shared keys summed and
    saturated at ``count_cap``, traveled bits ORed.  The result has a's
    capacities and ``nelts = a.nelts + b.nelts``.  A plain sort and fold,
    as in the JAX package (no kernel there either)."""
    kshift, cb, cap = payload_bits(key_bits), cbits(key_bits), \
        count_cap(key_bits)
    packed = bits.usort(torch.cat([a.store, b.store]))
    sent = packed == bits.SENTINEL
    # sentinels keep the full all-ones key, so they never share a run with
    # a real entry of the maximum key
    keys = torch.where(sent, bits.SENTINEL, bits.srl(packed, kshift))
    counts = torch.where(sent, 0, packed & ((1 << cb) - 1))
    # within a key run the traveled copy sorts last (its bit sits above
    # the count), so the run's last entry carries the OR of the run
    trav = (packed >> cb) & 1
    S = torch.cumsum(counts, 0)
    edge = keys[1:] != keys[:-1]
    one = torch.ones(1, dtype=torch.bool, device=packed.device)
    first, last = torch.cat([one, edge]), torch.cat([edge, one])
    U = torch.cummax(torch.where(first, S - counts, -1), 0).values
    totals = (S - U).clamp(max=cap)
    words = (keys << kshift) | (trav << cb) | totals
    return _compacted(words, last & ~sent, a, a.nelts + b.nelts)


def inner_product(a: Spectrum, b: Spectrum, key_bits: int) -> torch.Tensor:
    """Sum over shared keys of count_a * count_b (0-dim int64).  a's keys
    ascend already, so b is probed through ``query_join_sorted`` (K2 on
    CUDA tensors) with no sort."""
    ka, ca, _ = _entries(a, key_bits)
    return (ca * query_join_sorted(b, ka, key_bits).long()).sum()


def intersect(a: Spectrum, b: Spectrum, key_bits: int) -> Spectrum:
    """Keys present in both merged spectra with min(count_a, count_b) and
    a's traveled bit, in a's capacities; ``nelts`` is the sum of the kept
    counts.  b is probed like ``inner_product`` does."""
    ka, ca, ta = _entries(a, key_bits)
    cbc = query_join_sorted(b, ka, key_bits).long()
    counts = torch.minimum(ca, cbc)
    keep = (ka != bits.SENTINEL) & (cbc > 0)
    words = (ka << payload_bits(key_bits)) | (ta << cbits(key_bits)) | counts
    return _compacted(words, keep, a, counts[keep].sum())


def magnitude(a: Spectrum, key_bits: int) -> torch.Tensor:
    """sqrt(sum count^2) over the store (0-dim float64)."""
    _, ca, _ = _entries(a, key_bits)
    v = ca.double()
    return torch.sqrt((v * v).sum())


# ---------------------------------------------------------------------------
# Host interop


def check_overflow(spec: Spectrum) -> None:
    """Raise if a merge produced more distinct keys than the capacity
    holds."""
    check_overflow_value(spec.n_main, spec.capacity)


def check_overflow_value(n_main, capacity: int) -> None:
    n = int(n_main)
    if n > capacity:
        raise RuntimeError(
            f"spectrum overflow: {n} distinct keys > capacity "
            f"{capacity}; raise qb / capacity")


def to_host(spec: Spectrum, key_bits: int):
    """Live (keys, counts, traveled) as numpy arrays (requires a merged
    store)."""
    n = min(spec.n_main, spec.capacity)
    keys, counts, trav = unpack_entries_np(
        bits.to_u64_np(spec.store[:n]), key_bits)
    return keys, counts, trav


def from_host(keys: np.ndarray, counts: np.ndarray, capacity: int,
              buf_capacity: int, key_bits: int,
              traveled: np.ndarray | None = None,
              device="cuda") -> Spectrum:
    """Build a merged device spectrum from host (key, count) arrays."""
    n = len(keys)
    if n > capacity:
        raise ValueError(f"{n} entries exceed capacity {capacity}")
    order = np.argsort(keys, kind="stable")
    kshift = payload_bits(key_bits)
    cb = cbits(key_bits)
    cap = count_cap(key_bits)
    c = np.minimum(np.asarray(counts, np.int64), cap).astype(np.uint64)
    t = (np.zeros(n, np.uint64) if traveled is None
         else np.asarray(traveled, np.uint64) & np.uint64(1))
    packed = (np.asarray(keys, np.uint64) << np.uint64(kshift)) | \
        (t << np.uint64(cb)) | c
    full = np.full(capacity, 0xFFFFFFFFFFFFFFFF, dtype=np.uint64)
    full[:n] = packed[order]
    return Spectrum(
        store=bits.from_u64_np(full, device),
        buf=torch.full((buf_capacity,), bits.SENTINEL, dtype=torch.int64,
                       device=device),
        n_main=n, n_buf=0, ndistinct=n,
        nelts=torch.tensor(int(np.asarray(counts, np.int64).sum()),
                           dtype=torch.int64, device=device),
    )


def _join_planes(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    return (np.asarray(hi, np.uint64) << np.uint64(32)) | \
        np.asarray(lo, np.uint64)


def _split_planes(w: np.ndarray):
    return ((w >> np.uint64(32)).astype(np.uint32),
            (w & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def from_jax_planes(hi, lo, buf_hi, buf_lo, n_main, n_buf, ndistinct, nelts,
                    device="cuda") -> Spectrum:
    """A Spectrum from the JAX package's state (numpy u32 planes and
    scalars), so both packages can start from one state."""
    return Spectrum(
        store=bits.from_u64_np(_join_planes(hi, lo), device),
        buf=bits.from_u64_np(_join_planes(buf_hi, buf_lo), device),
        n_main=int(n_main), n_buf=int(n_buf), ndistinct=int(ndistinct),
        nelts=torch.tensor(int(nelts), dtype=torch.int64, device=device),
    )


def to_jax_planes(spec: Spectrum) -> dict:
    """The state in the JAX package's layout (numpy): hi/lo and buf_hi/
    buf_lo u32 planes (buffer slots past n_buf as sentinels, as the JAX
    merge leaves them) and the four counters as ints."""
    hi, lo = _split_planes(bits.to_u64_np(spec.store))
    b = bits.to_u64_np(spec.buf).copy()
    b[spec.n_buf:] = np.uint64(0xFFFFFFFFFFFFFFFF)
    buf_hi, buf_lo = _split_planes(b)
    return dict(hi=hi, lo=lo, buf_hi=buf_hi, buf_lo=buf_lo,
                n_main=int(spec.n_main), n_buf=int(spec.n_buf),
                ndistinct=int(spec.ndistinct), nelts=int(spec.nelts))
