"""Pipeline-parallel ensemble sampling (port of
sdm_tpu/parallel/pipeline.py).

An ensemble bundle chains its models: model k denoises over its own
[min_noise, max_noise] range and hands x_t to model k+1. With the models
on different devices and the batch cut into microbatches, microbatch m
can run stage k while microbatch m+1 runs stage k-1. CUDA launches are
asynchronous, so the host loop below only enqueues each stage's work on
its device and the copies between devices; the devices overlap wherever
the host enqueues faster than they run. The generator opts in with
--pipeline M (cli/generate_images_diffusion.py).
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch


def pipeline_chain(stage_fns: Sequence[Callable], stage_devices: Sequence,
                   x: torch.Tensor, num_microbatches: int) -> torch.Tensor:
    """Run `x` (batch first) through `stage_fns` in order, cut into
    `num_microbatches` equal microbatches along dim 0, stage k on
    stage_devices[k].

    stage_fns[k](x_m, m) -> x_m' runs on the device x_m lies on, with its
    model resident there; `m` is the microbatch index (for per-microbatch
    noise streams). Returns the concatenated result on stage_devices[-1].
    """
    n = x.shape[0]
    if n % num_microbatches != 0:
        raise ValueError(
            f"batch {n} not divisible by --pipeline {num_microbatches} "
            "microbatches (uneven shapes would recompile every stage)")
    size = n // num_microbatches
    outs: List[torch.Tensor] = []
    for m in range(num_microbatches):
        xm = x[m * size:(m + 1) * size]
        for fn, dev in zip(stage_fns, stage_devices):
            xm = fn(xm.to(dev, non_blocking=True), m)
        outs.append(xm)
    return torch.cat(outs, dim=0)
