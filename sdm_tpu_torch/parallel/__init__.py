"""Multi-device execution of the port (port of sdm_tpu/parallel/):
data-parallel training under DDP and FSDP2, the multi-process launch,
data-parallel sampling replicas, the pipelined ensemble, tensor
parallelism (tp.py), spatial partitioning (sp.py), FSDP2 composed with
both, and the collective bytes of a step (analysis.py)."""

from sdm_tpu_torch.parallel.mesh import (Replicas, data_parallel_size,
                                         make_mesh, shard_batch)
