"""GroupNorm with torch.nn.GroupNorm semantics over the channel (last) axis
(port of sdm_tpu/ops/norms.py): contiguous channel groups, biased variance,
eps inside the sqrt, per-channel affine, statistics in fp32.

The plain two-pass version (mean, then E[(x - mean)^2]); the fused AdaGN
kernel (kernels/adagn.py) is held against it.
"""

from __future__ import annotations

import torch


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over the last axis of an (N, ..., C) tensor; returns x's
    dtype."""
    orig_dtype = x.dtype
    n, c = x.shape[0], x.shape[-1]
    if c % num_groups != 0:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    xg = x.to(torch.float32).reshape(n, -1, num_groups, c // num_groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    xn = (xg - mean) * torch.reciprocal(torch.sqrt(var + eps))
    xn = xn.reshape(x.shape)
    out = xn * scale.to(torch.float32) + bias.to(torch.float32)
    return out.to(orig_dtype)
