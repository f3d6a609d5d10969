"""Multi-device execution of the port (port of sdm_tpu/parallel/):
data-parallel training under DDP and FSDP2, the multi-process launch,
data-parallel sampling replicas and the pipelined ensemble. Tensor and
spatial partitioning (sdm_tpu's tp.py, sp.py) and the collective analysis
(analysis.py) are not ported yet (ROADMAP Queue 1 item 9)."""

from sdm_tpu_torch.parallel.mesh import (Replicas, data_parallel_size,
                                         make_mesh, shard_batch)

PARALLEL_ITEM = "ROADMAP Queue 1 item 9 (parallel)"
