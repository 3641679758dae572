"""The collective interface the shard programs are written against.

The JAX layer runs its shard programs inside ``shard_map`` and uses three
collectives: ``all_gather``, ``all_to_all`` (split and concatenated on
axis 0, untiled) and ``psum``.  The port writes each shard program as
plain functions on tensors, split at those points, and calls a back end
for the exchange.  A mesh has ``n`` shards with global ids 0 .. n-1; a
process holds the shards ``shard_ids`` (process-major: process r holds
r * local .. r * local + local - 1, as in the JAX global mesh).  A back
end sees one list entry per shard the process holds and returns what each
of those shards receives:

  all_gather(parts)  every shard's tensor, concatenated in global shard
                     order (one tensor, read by every shard)
  all_to_all(rows)   rows[i] is [n, W], row d bound for global shard d;
                     the shard with global id d receives the [n * W]
                     concatenation over all global sources s of their
                     row d.  W is the same on every shard of the mesh.
  psum(values)       the sum over every process of the integers each
                     hands in (one a shard, or one a process)
  pmax(values)       their maximum

``InProcess`` keeps all n shard states in Python lists on one device:
the counterpart of the JAX tests' virtual CPU mesh, and the way one GPU
runs n key-range shards.  Its callers run the shard programs one shard
after another between two collectives, so the device holds every shard's
state and exchange rows but only one shard's temporaries at a time.

``Distributed`` holds ``local`` shards in each process of the default
``torch.distributed`` group, which the caller initialises (as a JAX user
calls ``jax.distributed.initialize``): NCCL when each process has its own
card, gloo on CPU processes and for processes that share a card (NCCL
refuses two ranks on one device).  Every process must make the same
collective calls in the same order; a process that raises leaves the
others waiting in their next call until the group's timeout.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..utils import profiling


class InProcess:
    """n shards in one process, all on one device."""

    def __init__(self, n: int, device="cuda"):
        self.n = n
        self.device = torch.device(device)
        self.shard_ids = range(n)

    def all_gather(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """The shards' tensors concatenated in shard order (one tensor,
        read by every shard)."""
        return torch.cat(parts)

    def all_to_all(self, rows: list[torch.Tensor]) -> list[torch.Tensor]:
        """rows[s][d] goes from shard s to shard d; shard d receives its
        rows from every s in shard order, concatenated."""
        return [torch.cat([r[d] for r in rows]) for d in range(self.n)]

    def psum(self, values) -> int:
        """The sum of the integers handed in."""
        return sum(int(v) for v in values)

    def pmax(self, values) -> int:
        """The largest of the integers handed in."""
        return max(int(v) for v in values)


class Distributed:
    """``local`` shards in each process of the default process group,
    ``n = world * local`` in all, on this process's ``device``.  The
    tensors go to the group's back end as they are: gloo takes CUDA
    tensors too and copies them through host memory itself.  The back end
    never changes by itself."""

    def __init__(self, local: int, device="cuda"):
        if not dist.is_available() or not dist.is_initialized():
            raise ValueError("Distributed needs the default process group: "
                             "call torch.distributed.init_process_group "
                             "first")
        self.world = dist.get_world_size()
        rank = dist.get_rank()
        self.local = local
        self.n = self.world * local
        self.device = torch.device(device)
        self.shard_ids = range(rank * local, (rank + 1) * local)
        if dist.get_backend() == "nccl" and self.device.type != "cuda":
            raise ValueError("the NCCL back end exchanges CUDA tensors; "
                             f"this mesh's device is {self.device}")

    def _scalar(self, value: int, op) -> int:
        with profiling.phase("mesh:exchange"):
            t = torch.tensor([value], dtype=torch.int64, device=self.device)
            dist.all_reduce(t, op=op)
            return int(t)

    def all_gather(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """Every shard's tensor (1-D, lengths may differ) concatenated in
        global shard order: the lengths first, then the parts padded to
        the longest."""
        with profiling.phase("mesh:exchange"):
            lens = torch.tensor([p.numel() for p in parts], dtype=torch.int64,
                                device=self.device)
            all_lens = [torch.empty_like(lens) for _ in range(self.world)]
            dist.all_gather(all_lens, lens)
            sizes = torch.cat(all_lens).tolist()
            width = max(sizes)
            mine = torch.zeros((self.local, width), dtype=parts[0].dtype,
                               device=self.device)
            for i, p in enumerate(parts):
                mine[i, :p.numel()] = p
            got = [torch.empty_like(mine) for _ in range(self.world)]
            dist.all_gather(got, mine)
            rows = torch.cat(got)
            return torch.cat([rows[s, :m] for s, m in enumerate(sizes)])

    def all_to_all(self, rows: list[torch.Tensor]) -> list[torch.Tensor]:
        """One ``all_to_all_single`` on a contiguous [world, local, local,
        W] tensor: block [r, i, j] is local shard i's row for shard j of
        process r."""
        with profiling.phase("mesh:exchange"):
            W = rows[0].shape[1]
            x = torch.stack(rows).reshape(
                self.local, self.world, self.local, W).transpose(
                    0, 1).contiguous()
            y = torch.empty_like(x)
            dist.all_to_all_single(y, x)
            del x
            # y[r, i, j] came from global shard r * local + i to my shard j
            return [y[:, :, j].reshape(-1) for j in range(self.local)]

    def psum(self, values) -> int:
        """The sum of the integers handed in, over every process."""
        return self._scalar(sum(int(v) for v in values), dist.ReduceOp.SUM)

    def pmax(self, values) -> int:
        """The largest of the integers handed in, over every process."""
        return self._scalar(max(int(v) for v in values), dist.ReduceOp.MAX)
