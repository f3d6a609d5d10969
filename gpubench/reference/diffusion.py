"""Plain float32 sampling and training around the reference U-Net: the
linear noise schedule, deterministic DDIM, cold sampling, the SR cascade
stage, the SR residual loss and Adam, as the published repository defines
them (diffusion_sampling_algorithms.py, the SR trainer).

This module imports nothing of the program under test.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from gpubench.reference.unet import Params, Quant, unet


def alpha_bar(beta_1: float, beta_T: float, max_t: int,
              device) -> torch.Tensor:
    """alpha_bar over steps 0..max_t of the linear beta schedule."""
    beta = torch.linspace(beta_1, beta_T, max_t + 1, dtype=torch.float32,
                          device=device)
    return torch.cumprod(1.0 - beta, dim=0)


def skip_steps(min_t: int, max_t: int, size: int) -> List[int]:
    """max_t, max_t - size, ... down to min_t, with min_t appended when the
    stride misses it."""
    steps = list(range(max_t, min_t - 1, -size))
    return steps if steps[-1] == min_t else steps + [min_t]


def q_sample(abar_t, x0, eps):
    return abar_t ** 0.5 * x0 + (1.0 - abar_t) ** 0.5 * eps


def ddim(p: Params, cfg: dict, abar: torch.Tensor, noise: torch.Tensor,
         steps: List[int], quant: Quant = None) -> torch.Tensor:
    """Deterministic DDIM (eta 0) from x_T = noise over `steps`; returns
    the last x0 estimate when the last step is 1, else the last x_t."""
    x = noise
    for i, t in enumerate(steps):
        tt = torch.tensor([t], device=x.device)
        eps = unet(p, cfg, x, tt, quant)
        x0 = (x - (1.0 - abar[t]) ** 0.5 * eps) / abar[t] ** 0.5
        if i + 1 == len(steps):
            return x0 if t == 1 else x
        a_next = abar[steps[i + 1]]
        x = a_next ** 0.5 * x0 + (1.0 - a_next) ** 0.5 * eps


def cold(p: Params, cfg: dict, abar: torch.Tensor, noise: torch.Tensor,
         steps: List[int], cond: torch.Tensor,
         quant: Quant = None) -> torch.Tensor:
    """Cold sampling of an x0-predicting model conditioned on `cond`
    (channels appended to x), the degradation noise shared by the
    trajectory; returns the model's last reconstruction."""
    x = noise
    for i, t in enumerate(steps):
        tt = torch.tensor([t], device=x.device)
        x0 = unet(p, cfg, torch.cat([x, cond], dim=-1), tt, quant)
        if i + 1 == len(steps):
            return x0
        t_next = steps[i + 1]
        x = x - q_sample(abar[t], x0, noise) + q_sample(abar[t_next], x0,
                                                        noise)


def area(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """NHWC area resize (adaptive average pooling)."""
    return F.interpolate(x.permute(0, 3, 1, 2), size=(h, w),
                         mode="area").permute(0, 2, 3, 1)


def sr_sample(p: Params, cfg: dict, abar: torch.Tensor, noise: torch.Tensor,
              lr: torch.Tensor, steps: List[int], cond_t: int,
              quant: Quant = None) -> torch.Tensor:
    """The cascade's SR stage: the LR image (N, h, w, C) area-upsampled to
    the noise's size, q-sampled at cond_t with the same noise as the
    conditioning, cold-sampled, and the predicted residual added back."""
    up = area(lr, noise.shape[1], noise.shape[2])
    cond = q_sample(abar[cond_t], up, noise)
    return up + cold(p, cfg, abar, noise, steps, cond, quant)


def sr_inputs(images_u8: torch.Tensor, abar: torch.Tensor, t: torch.Tensor,
              eps: torch.Tensor, cond_t: int, lr_dim: int):
    """(model input, target) of the SR residual objective: the HR image in
    [-1, 1], its LR round trip lr_up, the target HR - lr_up, and the input
    [q_sample(HR, t), q_sample(lr_up, cond_t)] with one eps."""
    x = (images_u8.to(torch.float32) - 127.5) / 127.5
    h, w = x.shape[1], x.shape[2]
    lr_up = area(area(x, lr_dim, lr_dim), h, w)
    a_t = abar[t][:, None, None, None]
    x_in = torch.cat([q_sample(a_t, x, eps), q_sample(abar[cond_t], lr_up,
                                                      eps)], dim=-1)
    return x_in, x - lr_up


def sr_loss_and_grads(p: Params, cfg: dict, abar: torch.Tensor,
                      images_u8: torch.Tensor, t: torch.Tensor,
                      eps: torch.Tensor, cond_t: int, lr_dim: int,
                      rows: int, quant: Quant = None, keep: int = None):
    """The mean squared error over the batch (or its first `keep` rows) and
    its gradient for every parameter, computed `rows` images at a time so
    that it fits. Returns (loss, {name: grad})."""
    n = images_u8.shape[0] if keep is None else keep
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    grads = {k: torch.zeros_like(v) for k, v in p.items()}
    total = 0.0
    for r0 in range(0, n, rows):
        r1 = min(n, r0 + rows)
        x_in, target = sr_inputs(images_u8[r0:r1], abar, t[r0:r1],
                                 eps[r0:r1], cond_t, lr_dim)
        pred = unet(leaves, cfg, x_in, t[r0:r1], quant)
        part = torch.sum(torch.square(pred - target)) / (
            n * target[0].numel())
        got = torch.autograd.grad(part, list(leaves.values()),
                                  allow_unused=True)
        for (k, _), g in zip(leaves.items(), got):
            if g is not None:
                grads[k] += g
        total += float(part.detach())
    return total, grads


class Adam:
    """Adam with bias correction: p -= lr * m_hat / (sqrt(v_hat) + eps)."""

    def __init__(self, params: Params, lr: float, betas=(0.5, 0.999),
                 eps: float = 1e-8):
        self.lr, self.betas, self.eps = lr, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    def step(self, params: Params, grads: Dict[str, torch.Tensor]) -> None:
        self.count += 1
        b1, b2 = self.betas
        c1, c2 = 1.0 - b1 ** self.count, 1.0 - b2 ** self.count
        for k, g in grads.items():
            self.m[k].mul_(b1).add_(g, alpha=1.0 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = (self.v[k] / c2).sqrt_().add_(self.eps)
            params[k].sub_(self.lr * (self.m[k] / c1) / denom)
