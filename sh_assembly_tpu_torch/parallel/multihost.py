"""Multi-process scale-out: the global mesh, per-process file partitioning
and batch placement.

Counterpart of ``sh_assembly_tpu/parallel/multihost.py``.  Every process
of a job streams its own round-robin slice of the read files, feeds its
rows to the shards it holds, and the collective steps of
``parallel/sharded.py`` and ``parallel/sharded_contiger.py`` run over the
global mesh (``collectives.Distributed``) with a per-batch agreement on
how many processes still have data.

Usage, in every process, after ``torch.distributed.init_process_group``
(NCCL with a card a process, ``torch.cuda.set_device`` first; gloo on the
CPU or for processes that share a card):

    mesh = multihost.make_global_mesh(device, local=1)
    sc = sharded.ShardedCounter(mesh=mesh, ...)
    files = multihost.partition_files(all_files)
    stream = multihost.coordinated_stream(
        native.batches_from_files(files, ...), mesh, make_empty)
    for b in stream:
        codes, lengths = multihost.shard_host_batch(mesh, b.codes,
                                                    b.lengths)
        ...

A job of one process gets today's single-process mesh
(``collectives.InProcess``), so the same code runs everywhere.
"""

from __future__ import annotations

import torch.distributed as dist

from . import collectives, sharded


def rank_and_world() -> tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_global_mesh(device="cuda", local: int | None = None):
    """The mesh over every process of the job: ``local`` shards a process
    (default 1) over the initialised process group.  With no group, or a
    group of one, the single-process mesh of ``local`` shards on
    ``device`` (default one a visible device of its kind)."""
    if rank_and_world()[1] <= 1:
        return sharded.make_mesh(local, device)
    mesh = collectives.Distributed(1 if local is None else local, device)
    sharded.check_mesh_size(mesh.n)
    return mesh


def partition_files(paths: list[str], process_index: int | None = None,
                    process_count: int | None = None) -> list[str]:
    """Round-robin slice of the read files owned by this process (by
    default the group's rank and world size)."""
    rank, world = rank_and_world()
    pi = rank if process_index is None else process_index
    pc = world if process_count is None else process_count
    if pc <= 1:
        return list(paths)
    return [p for i, p in enumerate(paths) if i % pc == pi]


def coordinated_stream(local_batches, mesh, make_empty):
    """Wrap a process-local batch iterator so that every process yields the
    same number of batches: a process whose files run out yields
    ``make_empty()`` until every process is done.

    The collective steps need every process to make the same calls; with
    round-robin file partitioning one process's stream can end first and
    the others would wait in their next all_to_all.  The agreement is one
    ``psum`` a batch of "this process still has a batch".  A mesh in one
    process skips it."""
    it = iter(local_batches)
    if not sharded.spans_processes(mesh):
        yield from it
        return
    while True:
        nxt = next(it, None)
        if mesh.psum([nxt is not None]) == 0:
            return
        yield make_empty() if nxt is None else nxt


def shard_host_batch(mesh, codes, lengths):
    """This process's batch split by rows across the shards it holds: the
    process's rows of the global batch, which has world x its rows."""
    return sharded.shard_rows(mesh, codes, lengths)
