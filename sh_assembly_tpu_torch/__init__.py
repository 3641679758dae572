"""De novo genome assembly on an NVIDIA GPU: the PyTorch/CUDA port.

A second package beside ``sh_assembly_tpu`` (the JAX reference), with the
same layout and module names so each module's counterpart is easy to find.
Plain tensor code is PyTorch; every Pallas kernel of the JAX package is a
hand-written CUDA kernel for Hopper under ``csrc/``, built by nvcc at its
first launch and bound with ctypes beside a plain PyTorch twin: K1 the
store merge (``ops/merge_cuda.py``), K2 the count join
(``ops/join_cuda.py``), K3 the node-store fold (``ops/merge128_cuda.py``)
and K4 the window sort (``ops/blocksort_cuda.py``).  Every function that
touches a device takes an explicit ``device``, and the entry points default
to ``cuda``; the package imports torch and numpy only.

It covers all of the JAX package: counting (``cli.cqf_denoise``, reads ->
reference-format ``.ser``), the Contiger (``cli.contiger``), the pipeline
(``cli.pipeline``, reads -> unitigs -> contigs), the library surface
(traveled queries, set operations) and the tools (``cli.minia``,
``cli.compare_contigs``, ``cli.cqf_dump``), the mesh layers
(``parallel/``: key-range shards in one process or across the processes
of a ``torch.distributed`` group), the profiling modules (``profile/``)
and the bench (``python -m sh_assembly_tpu_torch.bench``).
"""

import torch  # noqa: F401  (the one framework this package uses)

__version__ = "0.1.0"
