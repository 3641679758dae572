"""The collective interface the shard programs are written against.

The JAX layer runs its shard programs inside ``shard_map`` and uses three
collectives: ``all_gather``, ``all_to_all`` (split and concatenated on
axis 0, untiled) and ``psum``.  The port writes each shard program as
plain functions on tensors, split at those three points, and calls a
back end for the exchange.  A back end sees one list entry per shard it
holds and returns what each of those shards receives:

  all_gather(parts)  every shard's tensor, concatenated in shard order
  all_to_all(rows)   rows[s] is [n, Q], row d bound for shard d; shard d
                     receives the [n * Q] concatenation over s of rows[s][d]
  psum(values)       the sum of one integer per shard

``InProcess`` keeps all n shard states in Python lists on one device:
the counterpart of the JAX tests' virtual CPU mesh, and the way one GPU
runs n key-range shards.  Its callers run the shard programs one shard
after another between two collectives, so the device holds every shard's
state and exchange rows but only one shard's temporaries at a time.  A
back end over ``torch.distributed`` would hold one shard a process and
answer the same three calls.
"""

from __future__ import annotations

import torch


class InProcess:
    """n shards in one process, all on one device."""

    def __init__(self, n: int, device="cuda"):
        self.n = n
        self.device = torch.device(device)

    def all_gather(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """The shards' tensors concatenated in shard order (one tensor,
        read by every shard)."""
        return torch.cat(parts)

    def all_to_all(self, rows: list[torch.Tensor]) -> list[torch.Tensor]:
        """rows[s][d] goes from shard s to shard d; shard d receives its
        rows from every s in shard order, concatenated."""
        return [torch.cat([r[d] for r in rows]) for d in range(self.n)]

    def psum(self, values) -> int:
        """The sum over shards of one integer each."""
        return sum(int(v) for v in values)
