"""Forward-process noise schedules (port of sdm_tpu/ops/schedules.py).

  - LinearSchedule: beta is a (T+1)-entry linspace so step indices 0..T
    index directly; alpha = 1 - beta; alpha_bar = cumprod(alpha). The tables
    live on the schedule's device.
  - CosineSchedule: Nichol-Dhariwal cosine alpha_bar computed on the fly
    (offset 0.008); beta = 1 - alpha_bar(t)/alpha_bar(t-1) clipped to
    [0.001, 0.999].

`steps` arguments are integer tensors (or Python ints / lists); results are
fp32 tensors on the steps' device (LinearSchedule: the tables' device).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple, Union

import torch


def _as_steps(steps, device) -> torch.Tensor:
    if isinstance(steps, torch.Tensor):
        return steps.to(device)
    return torch.as_tensor(steps, device=device)


@dataclass
class LinearSchedule:
    """Linear beta schedule (DDPM-style) with precomputed tables."""

    beta: torch.Tensor       # (T+1,)
    alpha: torch.Tensor      # (T+1,)
    alpha_bar: torch.Tensor  # (T+1,)
    beta_1: float = 5e-3
    beta_T: float = 9e-3
    max_noise_step: int = 1000

    @classmethod
    def create(cls, beta_1: float, beta_T: float, max_noise_step: int,
               device=None) -> "LinearSchedule":
        beta = torch.linspace(beta_1, beta_T, int(max_noise_step) + 1,
                              dtype=torch.float32, device=device)
        alpha = 1.0 - beta
        alpha_bar = torch.cumprod(alpha, dim=0)
        return cls(beta=beta, alpha=alpha, alpha_bar=alpha_bar,
                   beta_1=float(beta_1), beta_T=float(beta_T),
                   max_noise_step=int(max_noise_step))

    def to(self, device) -> "LinearSchedule":
        return LinearSchedule(self.beta.to(device), self.alpha.to(device),
                              self.alpha_bar.to(device), self.beta_1,
                              self.beta_T, self.max_noise_step)

    def timestep_params(self, steps) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
        steps = _as_steps(steps, self.beta.device)
        return self.beta[steps], self.alpha[steps], self.alpha_bar[steps]

    def alpha_bar_at(self, steps) -> torch.Tensor:
        return self.alpha_bar[_as_steps(steps, self.alpha_bar.device)]

    def q_sample(self, img: torch.Tensor, steps, eps: torch.Tensor
                 ) -> torch.Tensor:
        """x_t = sqrt(alpha_bar_t) * x_0 + sqrt(1 - alpha_bar_t) * eps."""
        return _q_sample(self.alpha_bar_at(steps), img, eps)


@dataclass
class CosineSchedule:
    """Nichol-Dhariwal cosine schedule; alpha_bar computed on the fly."""

    max_noise_step: int = 1000
    offset: float = 0.008

    @classmethod
    def create(cls, max_noise_step: int) -> "CosineSchedule":
        return cls(max_noise_step=int(max_noise_step))

    def to(self, device) -> "CosineSchedule":
        return self

    def alpha_bar_at(self, steps) -> torch.Tensor:
        steps = torch.as_tensor(steps).to(torch.float32)
        half_pi = math.pi / 2
        f_t = torch.cos(((steps / self.max_noise_step + self.offset)
                         / (1.0 + self.offset)) * half_pi) ** 2
        f_0 = math.cos((self.offset / (1.0 + self.offset)) * half_pi) ** 2
        return f_t / f_0

    def timestep_params(self, steps) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
        steps = torch.as_tensor(steps)
        alpha_bar = self.alpha_bar_at(steps)
        alpha_bar_prev = self.alpha_bar_at(steps - 1)
        beta = torch.clamp(1.0 - alpha_bar / alpha_bar_prev, 0.001, 0.999)
        return beta, 1.0 - beta, alpha_bar

    def q_sample(self, img: torch.Tensor, steps, eps: torch.Tensor
                 ) -> torch.Tensor:
        return _q_sample(self.alpha_bar_at(steps), img, eps)


Schedule = Union[LinearSchedule, CosineSchedule]


def _q_sample(alpha_bar: torch.Tensor, img: torch.Tensor,
              eps: torch.Tensor) -> torch.Tensor:
    alpha_bar = alpha_bar.to(device=img.device, dtype=img.dtype)
    while alpha_bar.ndim < img.ndim:
        alpha_bar = alpha_bar[..., None]
    return alpha_bar ** 0.5 * img + (1.0 - alpha_bar) ** 0.5 * eps


def make_schedule(noise_scheduler: str, *, beta_1: float = 5e-3,
                  beta_T: float = 9e-3, max_noise_step: int = 1000,
                  device=None) -> Schedule:
    """Build a schedule from the config vocabulary ("LINEAR"/"COSINE")."""
    name = str(noise_scheduler).upper()
    if name == "LINEAR":
        return LinearSchedule.create(beta_1, beta_T, max_noise_step,
                                     device=device)
    if name == "COSINE":
        return CosineSchedule.create(max_noise_step)
    raise ValueError("Invalid noise scheduler type.")
