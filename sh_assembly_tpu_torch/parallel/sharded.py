"""Sharded counting: key-range shards over a collective back end.

Counterpart of ``sh_assembly_tpu/parallel/sharded.py``.  Shard i of an
n-shard mesh owns the keys whose top log2(n) bits equal i, so the shards'
sorted stores concatenated in shard order are the globally sorted store.
Every shard hashes its own rows of a read batch (kernel K5, one launch a
shard for a step or for a scan's whole stack) and owns a key range:

  step:   hash local rows -> all_gather keys -> keep the keys this shard
          owns -> local append (merge first when the block would not fit)
  scan:   hash local rows -> sort -> cut per-owner quota rows ->
          all_to_all -> local append; merges are the host's (driver.py)
  merge:  per-shard sort and fold (kernel K1 on CUDA tensors)
  sweep:  deNoise compaction on every shard, when the summed distinct
          count reaches the threshold and rounds remain

A "mesh" is the shard count and its collective back end
(``collectives.InProcess``: every shard on the one device it names;
``collectives.Distributed``: ``local`` shards in each process of a
``torch.distributed`` group).  A shard's state is a ``spectrum.Spectrum``;
the counter passes a list with one for each shard this process holds
(``mesh.shard_ids``), and every width and decision that crosses shards
goes through a collective, so that every process takes the same branch.

Keys are int64 words holding unsigned patterns (``ops/bits``): owners
come from a logical shift, sorts and searches flip the top bit, and the
sentinel -1 gets owner n, past every real owner.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import bits, hash_append_cuda, spectrum as sp
from . import collectives


def check_mesh_size(n: int) -> None:
    if n < 1 or n & (n - 1):
        raise ValueError(
            f"mesh size {n} is not a power of two: key-range ownership is "
            f"by top key bits (shard_bits = log2(n)), a non-power-of-two "
            f"mesh would silently leave shards idle; pass n_devices=2^k")


def make_mesh(n_devices: int | None = None,
              device="cuda") -> collectives.InProcess:
    """n_devices key-range shards on ``device`` (None: one a device of its
    kind that this process sees; the CPU counts as one)."""
    n = n_devices
    if n is None:
        n = torch.cuda.device_count() if torch.device(device).type == \
            "cuda" else 1
    check_mesh_size(n)
    return collectives.InProcess(n, device)


def spans_processes(mesh) -> bool:
    """Whether other processes hold some of the mesh's shards."""
    return len(mesh.shard_ids) != mesh.n


def _to_device(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def split_rows(mesh, a, axis: int = 0):
    """Split this process's host or device array into equal row blocks
    along ``axis``, one for each shard it holds, on the mesh's device."""
    n, B = len(mesh.shard_ids), a.shape[axis]
    if B % n:
        raise ValueError(f"batch rows {B} not divisible by the {n} shards "
                         f"of the mesh in this process")
    Bl = B // n
    idx = [slice(None)] * axis
    return [_to_device(a[tuple(idx + [slice(i * Bl, (i + 1) * Bl)])],
                       mesh.device) for i in range(n)]


def shard_rows(mesh, codes, lengths):
    """Split this process's batch by rows into per-shard device tensors:
    codes [B, L] and lengths [B], or stacks [S, B, L] and [S, B] (split on
    B)."""
    axis = codes.ndim - 2
    return split_rows(mesh, codes, axis), split_rows(mesh, lengths, axis)


def quota_rows(sorted_vals: torch.Tensor, bounds: torch.Tensor, Q: int,
               fill, width: int | None = None):
    """Per-owner rows cut from a sorted array: row o holds
    sorted_vals[bounds[o]:bounds[o + 1]], at most Q of them, padded with
    ``fill`` to ``width`` (default Q; a narrower width must hold every
    owner's count).  Returns (rows [n, width], entries beyond the quota Q
    as a 0-dim int64 tensor)."""
    width = Q if width is None else width
    dev = sorted_vals.device
    start = bounds[:-1].long()
    cnt = bounds[1:].long() - start
    iota = torch.arange(width, device=dev)
    padded = torch.cat([sorted_vals, torch.full(
        (width,), fill, dtype=sorted_vals.dtype, device=dev)])
    rows = torch.where(iota[None, :] < cnt[:, None],
                       padded[start[:, None] + iota[None, :]], fill)
    return rows, (cnt - Q).clamp(min=0).sum()


def row_width(mesh, bounds: list[torch.Tensor], Q: int) -> int:
    """The narrowest row width that loses nothing the quota Q keeps: the
    largest owner count over every shard's bounds in the mesh, capped at
    Q (agreed, so that every process builds rows of one width)."""
    return min(Q, mesh.pmax(int((b[1:] - b[:-1]).max()) for b in bounds))


@dataclass(frozen=True)
class ShardedCounter:
    """Counting over a fixed mesh; per-shard states are lists of
    ``Spectrum``, one for each shard this process holds."""

    mesh: collectives.InProcess | collectives.Distributed
    k: int
    key_bits: int
    local_capacity: int
    local_buf_capacity: int

    @property
    def n_shards(self) -> int:
        return self.mesh.n

    @property
    def shard_bits(self) -> int:
        return self.n_shards.bit_length() - 1

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def init(self) -> list[sp.Spectrum]:
        """Empty spectra for the shards this process holds."""
        return [sp.make(self.local_capacity, self.local_buf_capacity,
                        self.device) for _ in self.mesh.shard_ids]

    def shard_batch(self, codes, lengths):
        """This process's batch split by rows across its shards
        (``shard_rows``)."""
        return shard_rows(self.mesh, codes, lengths)

    # -- per-shard pieces ---------------------------------------------------
    def _keys(self, codes: torch.Tensor, lengths: torch.Tensor):
        """Masked canonical keys of a row block [B, L] or a stack [S, B, L]
        (lengths [B] or [S, B]), flat in row then window order, -1 where
        invalid: one launch of K5 into a scratch buffer on CUDA tensors,
        its plain version on CPU tensors."""
        dev = codes.device
        W = max(codes.shape[-1] - self.k + 1, 0)
        keys = torch.empty(lengths.numel() * W, dtype=torch.int64,
                           device=dev)
        hash_append_cuda.hash_append(
            keys, 0, torch.zeros((), dtype=torch.int64, device=dev),
            lengths.to(torch.int32).contiguous(), self.k, self.key_bits,
            codes=codes.to(torch.uint8).contiguous())
        return keys

    def _owner(self, keys: torch.Tensor) -> torch.Tensor:
        """Owner shard of each key: its top shard_bits; n for the
        sentinel."""
        o = bits.srl(keys, self.key_bits - self.shard_bits)
        return torch.where(keys == -1, self.n_shards, o)

    def _merged(self, specs, drop_singletons=False):
        """Every shard's fold.  A store that overflows raises, as the
        single-device counter does (the JAX layer cuts it silently); the
        fullest store of the mesh decides, so every process raises."""
        specs = [sp.merge(s, self.key_bits, drop_singletons) for s in specs]
        sp.check_overflow_value(self.mesh.pmax(s.n_main for s in specs),
                                self.local_capacity)
        return specs

    # -- collective steps ---------------------------------------------------
    def step(self, specs, codes, lengths):
        """One counting superstep with all-gather routing.  codes/lengths
        are per-shard row blocks (``shard_batch``).  A shard merges its
        buffer first when the gathered block would overflow it."""
        BC = self.local_buf_capacity
        every = self.mesh.all_gather(
            [self._keys(c, ln) for c, ln in zip(codes, lengths)])
        if every.numel() > BC:
            raise ValueError(
                f"one superstep routes {every.numel()} keys but the local "
                f"buffer holds {BC}; raise local_buf_capacity")
        owner = self._owner(every)
        # every shard's buffer holds the same count: they merge together
        if specs[0].n_buf + every.numel() > BC:
            specs = self._merged(specs)
        return [sp.insert(spec, torch.where(owner == me, every, -1))
                for me, spec in zip(self.mesh.shard_ids, specs)]

    def routed_per_step(self, rows_local: int, L: int,
                        quota_slack: float = 2.0) -> int:
        """Buffer slots appended per scan step on every shard (the padded
        routed block n*Q; deterministic, so the host keeps the merge
        cadence exactly)."""
        n = self.n_shards
        W = rows_local * (L - self.k + 1)
        Q = int(np.ceil(W / n * quota_slack)) if n > 1 else W
        return n * Q if n > 1 else Q

    def _route_rows(self, keys, Q: int):
        """A shard's sending side of one scan step: its keys sorted and cut
        into per-owner quota rows [n, Q] -> (rows, dropped)."""
        n = self.n_shards
        srt = bits.usort(keys)
        bounds = torch.searchsorted(
            self._owner(srt), torch.arange(n + 1, device=srt.device))
        return quota_rows(srt, bounds, Q, -1)

    def append_scan(self, specs, codes, lengths, quota_slack: float = 2.0):
        """S routed appends with no merge between them: codes/lengths are
        per-shard stacks [S, Bl, L] and [S, Bl] (``shard_batch``).  Every
        shard appends its n*Q padded routed block a step (``Q = ceil(W/n *
        quota_slack)`` for W keys a shard), so the caller guarantees S
        blocks of headroom.  Returns (specs, dropped per shard): keys
        beyond a shard's quota, which must be 0."""
        n = self.n_shards
        S, Bl, L = codes[0].shape
        Q = self.routed_per_step(Bl, L, quota_slack) // n
        dropped = [torch.zeros((), dtype=torch.int64, device=self.device)
                   for _ in codes]
        # every shard's whole stack hashed at once; step s routes its slice
        keys = [self._keys(c, ln) for c, ln in zip(codes, lengths)]
        per_step = Bl * max(L - self.k + 1, 0)
        for s in range(S):
            step = [kk[s * per_step:(s + 1) * per_step] for kk in keys]
            if n > 1:
                sends = []
                for i, ks in enumerate(step):
                    rows, d = self._route_rows(ks, Q)
                    sends.append(rows)
                    dropped[i] += d
                got = self.mesh.all_to_all(sends)
                del sends
            else:
                got = step
            specs = [sp.insert(spec, g) for spec, g in zip(specs, got)]
            del got, step
        return specs, [int(d) for d in dropped]

    def merge_sweep(self, specs, rounds: int, threshold: int):
        """Per-shard buffer merge, then a deNoise sweep on every shard when
        rounds remain and the summed distinct count reaches the threshold
        -> (specs, rounds left)."""
        specs = self._merged(specs)
        if rounds > 0 and self.mesh.psum(
                s.ndistinct for s in specs) >= threshold:
            specs = [sp.sweep(s, self.key_bits) for s in specs]
            rounds -= 1
        return specs, rounds

    def merge(self, specs, drop_singletons: bool = False):
        return self._merged(specs, drop_singletons)

    def stats(self, specs) -> tuple[int, int]:
        """Global (ndistinct, nelts): sums over the shards."""
        return (self.mesh.psum(s.ndistinct for s in specs),
                self.mesh.psum(s.nelts for s in specs))

    # -- host interop -------------------------------------------------------
    def from_host(self, keys: np.ndarray, counts: np.ndarray,
                  traveled: np.ndarray | None = None) -> list[sp.Spectrum]:
        """Key-range-sharded spectra of the shards this process holds,
        from global sorted host arrays (the .ser load path of the mesh
        CLIs), by the counting ownership rule.  Every shard's ``nelts`` is
        the global total // n, as in the JAX layer (``stats`` sums
        them)."""
        n, Cl, kb = self.n_shards, self.local_capacity, self.key_bits
        keys = np.asarray(keys, np.uint64)
        counts = np.asarray(counts, np.int64)
        trav = (np.zeros(len(keys), np.uint8) if traveled is None
                else np.asarray(traveled, np.uint8))
        edges = np.array([o << (kb - self.shard_bits) for o in range(n + 1)],
                         np.uint64)
        bounds = np.searchsorted(keys, edges)
        nelts = int(counts.sum()) // n
        out = []
        for s in self.mesh.shard_ids:
            a, b = int(bounds[s]), int(bounds[s + 1])
            if b - a > Cl:
                raise ValueError(
                    f"shard {s} needs {b - a} slots > local capacity {Cl}")
            spec = sp.from_host(keys[a:b], counts[a:b], Cl,
                                self.local_buf_capacity, kb,
                                traveled=trav[a:b], device=self.device)
            out.append(dataclasses.replace(spec, nelts=torch.tensor(
                nelts, dtype=torch.int64, device=self.device)))
        return out

    def gather_spectrum(self, specs):
        """The shards' live entries concatenated -> global sorted (keys,
        counts) numpy arrays.  Single-process only, as in the JAX layer,
        whose host gather cannot read shards other processes hold (ROADMAP
        §3, fault 10)."""
        if spans_processes(self.mesh):
            raise ValueError(
                "gather_spectrum reads every shard's store, but other "
                "processes hold some of them (reference fault 10: the JAX "
                "layer cannot gather across processes either); dump each "
                "process's shards instead")
        parts = [sp.to_host(s, self.key_bits) for s in specs]
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]))
