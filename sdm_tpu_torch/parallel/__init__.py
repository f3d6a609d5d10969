"""Multi-device execution of the port (port of sdm_tpu/parallel/):
data-parallel training under DDP and FSDP2, the multi-process launch,
data-parallel sampling replicas, the pipelined ensemble, tensor
parallelism (tp.py), spatial partitioning (sp.py) and the collective
bytes of a step (analysis.py). Not ported yet (ROADMAP Queue 1 item 9,
third part): "fsdp" with "tp" or "sp", and "device_dataset" with "tp"."""

from sdm_tpu_torch.parallel.mesh import (Replicas, data_parallel_size,
                                         make_mesh, shard_batch)

PARALLEL_ITEM = "ROADMAP Queue 1 item 9 (parallel, third part)"
