"""Multi-host scale-out: per-process file partitioning and batch
placement.

Counterpart of ``sh_assembly_tpu/parallel/multihost.py``.  There, every
process of a job streams its own round-robin slice of the read files, and
the collectives run over the global mesh with a per-batch agreement on
how many processes still have data.  The port runs one process: its mesh
is ``collectives.InProcess``, so everything but ``partition_files`` is a
pass-through, kept so the drivers read as the JAX ones do.
"""

from __future__ import annotations

from . import collectives, sharded


def make_global_mesh(device="cuda") -> collectives.InProcess:
    """The mesh over every device of the job: one shard a visible device
    of the kind ``device`` names."""
    return sharded.make_mesh(None, device)


def partition_files(paths: list[str], process_index: int = 0,
                    process_count: int = 1) -> list[str]:
    """Round-robin slice of the read files owned by this process."""
    if process_count <= 1:
        return list(paths)
    return [p for i, p in enumerate(paths)
            if i % process_count == process_index]


def coordinated_stream(local_batches, mesh: collectives.InProcess,
                       make_empty):
    """Every process yields the same number of batches; with one process
    that is the local stream itself."""
    yield from local_batches


def shard_host_batch(mesh: collectives.InProcess, codes, lengths):
    """This process's batch split by rows across its shards."""
    return sharded.shard_rows(mesh, codes, lengths)
