"""Classifier-free guidance (port of sdm_tpu/diffusion/guidance.py; Ho &
Salimans 2022):

    eps_guided = eps_uncond + scale * (eps_cond - eps_uncond)

The "null" condition is the ZERO label vector: the conditional MLP's
output for it is a constant set by its biases, a learnable null token that
needs no new parameters. Training drops labels to it with probability
"cfg_drop_prob" (`dropout_labels`); sampling wraps any model_fn with
`cfg_model_fn`, so every eps sampler gains guidance unchanged.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

ModelFn = Callable[..., torch.Tensor]


def cfg_model_fn(model_fn: ModelFn, guidance_scale: float) -> ModelFn:
    """Wrap `model_fn` so each call evaluates the conditional and the
    zero-label branch in one doubled-batch call: conditional rows first,
    null rows second, combined in fp32.

    scale == 1.0 is the plain conditional model (returned unwrapped);
    scale == 0.0 the pure null-label model."""
    scale = float(guidance_scale)
    if scale == 1.0:
        return model_fn

    def guided(x: torch.Tensor, t: torch.Tensor,
               labels: Optional[torch.Tensor]) -> torch.Tensor:
        if labels is None:
            raise ValueError(
                "classifier-free guidance needs label conditioning "
                "(the model was sampled without labels)")
        x2 = torch.cat([x, x], dim=0)
        if labels.ndim == 1:
            # The generators pass one (cond_dim,) vector for the batch.
            labels = labels.expand(x.shape[0], labels.shape[0])
        l2 = torch.cat([labels, torch.zeros_like(labels)], dim=0)
        out = model_fn(x2, t, l2).to(torch.float32)
        e_cond, e_uncond = out.chunk(2, dim=0)
        return e_uncond + scale * (e_cond - e_uncond)

    # The combine is affine with weights summing to 1, so it is the same
    # extrapolation in v space: a v-model's tag rides through.
    guided.model_output = getattr(model_fn, "model_output", "eps")
    return guided


def dropout_labels(labels: Optional[torch.Tensor],
                   generator: Optional[torch.Generator],
                   drop_prob: float, shard=(0, 1)) -> Optional[torch.Tensor]:
    """Per-sample label dropout for CFG training: with probability
    `drop_prob` a sample's label vector becomes the zero vector, drawn from
    `generator`. No-op when labels is None or drop_prob == 0. `shard` =
    (rank, world): labels are rank's rows of a world-times larger batch,
    and the mask is drawn over the whole batch."""
    if labels is None or drop_prob <= 0.0:
        return labels
    rank, world = shard
    n = labels.shape[0]
    keep = torch.rand((n * world,), generator=generator,
                      device=labels.device)[rank * n:(rank + 1) * n] \
        < 1.0 - drop_prob
    return torch.where(keep[:, None], labels, torch.zeros_like(labels))
