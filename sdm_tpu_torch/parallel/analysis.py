"""Collective bytes of one step (port of sdm_tpu/parallel/analysis.py).

sdm_tpu compiles a step under a candidate mesh and counts the output bytes
of every collective in the optimized HLO: the data landing in each
device's memory. Here the step runs eagerly, so the count is taken where
the collectives are issued: every collective of parallel/_comm.py (TP's
input all-reduces and channel all-gathers, SP's halo exchanges, norm and
softmax all-reduces, key/value gathers and their reduce-scatters) and
every DistributedDataParallel gradient bucket (the comm hook of
_comm.data_parallel(..., count_bytes=True), the DDP this counts) adds its
bytes on this rank while a count is open.
The keys are sdm_tpu's.

The model behind the numbers (sdm_tpu's note): pure DP moves one gradient
all-reduce of the parameter bytes per step, whatever the batch; TP adds
activation gathers that grow with batch * H * W * C at every cut layer.
"""

from __future__ import annotations

from typing import Dict

from sdm_tpu_torch.parallel import _comm


def step_collective_bytes(fn, *args, **kwargs) -> Dict[str, int]:
    """Run fn(*args, **kwargs) once and return the bytes its collectives
    brought to this rank: {"all-reduce", "all-gather", "reduce-scatter",
    "collective-permute", "all-to-all", "total"}."""
    with _comm.counting() as counts:
        fn(*args, **kwargs)
    return dict(counts)
