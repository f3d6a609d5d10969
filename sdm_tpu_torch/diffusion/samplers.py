"""Reverse-process samplers (port of the eps-family and cold sampling of
sdm_tpu/diffusion/samplers.py). `lax.scan` becomes a Python loop; the step
indices live on the image's device, so a step enqueues device work only.

Rules kept from sdm_tpu (and the reference diffusion_sampling_algorithms.py):
  - ddpm_sample: sigma_t = sqrt(beta_t); z only when t > 1;
    x_{t-1} = (1/sqrt(a)) (x_t - ((1-a)/sqrt(1-abar)) eps_hat) + sigma z.
  - ddim_sample: step list range(max, min-1, -size) with min appended when
    missed; eta = 0 by default; the final visit returns x0 when the last
    step is exactly 1, else x_t.

`model_fn(x, t, labels)` takes NHWC x and a (1,) step tensor. Noise comes
from an explicit `torch.Generator` or is injected (`zs`) for tests.
v-parameterized models are a later slice.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

ModelFn = Callable[..., torch.Tensor]


def ddim_step_list(min_noise: int, max_noise: int, step_size: int
                   ) -> List[int]:
    """Skip-step schedule with the reference's append-min rule."""
    steps = list(range(max_noise, min_noise - 1, -step_size))
    if min_noise not in steps:
        steps = steps + [min_noise]
    return steps


def _concat_cond(x: torch.Tensor, cond_img: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    if cond_img is None:
        return x
    return torch.cat([x, cond_img.to(x.dtype)], dim=-1)


def _check_eps(model_fn: ModelFn) -> None:
    mo = str(getattr(model_fn, "model_output", "eps")).lower()
    if mo != "eps":
        raise NotImplementedError(
            f"model_output {mo!r}: only eps models are served by this slice")


def _to_eps_x0(raw: torch.Tensor, x: torch.Tensor, abar_t: torch.Tensor):
    """(eps_hat, x0_hat) in fp32 for an eps model: x0 = (x - s eps)/a."""
    s = (1.0 - abar_t) ** 0.5
    return raw, (x - s * raw) / abar_t ** 0.5


def _randn(shape, like: torch.Tensor, generator):
    return torch.randn(shape, generator=generator, device=like.device,
                       dtype=torch.float32)


def ddpm_sample(model_fn: ModelFn, schedule, x_t: torch.Tensor, *,
                generator: Optional[torch.Generator] = None,
                min_noise: int = 1, max_noise: int = 1000,
                cond_img: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None,
                zs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DDPM ancestral sampling. `zs` (num_steps, *x.shape) injects the
    per-step noise; otherwise it is drawn from `generator`."""
    _check_eps(model_fn)
    if zs is None and generator is None:
        raise ValueError("ddpm_sample needs a generator (or injected zs)")
    device = x_t.device
    steps = torch.arange(max_noise, min_noise - 1, -1, device=device)
    x = x_t.to(torch.float32)
    for i in range(steps.shape[0]):
        tvec = steps[i:i + 1]
        beta, alpha, alpha_bar = (p.to(torch.float32)
                                  for p in schedule.timestep_params(tvec))
        raw = model_fn(_concat_cond(x, cond_img), tvec, labels)
        eps_hat, _ = _to_eps_x0(raw.to(torch.float32), x, alpha_bar)
        z = (zs[i].to(torch.float32) if zs is not None
             else _randn(x.shape, x, generator))
        sigma = beta ** 0.5
        scale_1 = 1.0 / alpha ** 0.5
        scale_2 = (1.0 - alpha) / (1.0 - alpha_bar) ** 0.5
        x = scale_1 * (x - scale_2 * eps_hat)
        if max_noise - i > 1:   # z only when t > 1
            x = x + sigma * z
    return x


def ddim_sample(model_fn: ModelFn, schedule, x_t: torch.Tensor, *,
                min_noise: int = 1, max_noise: int = 1000,
                ddim_step_size: int = 10,
                cond_img: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None,
                eta: float = 0.0,
                generator: Optional[torch.Generator] = None,
                zs: Optional[torch.Tensor] = None,
                steps: Optional[List[int]] = None) -> torch.Tensor:
    """DDIM sampling (eta = 0 deterministic by default). For eta > 0 the
    per-step noise comes from `generator` or is injected via `zs`
    (len(steps) - 1, *x.shape)."""
    _check_eps(model_fn)
    steps = (list(steps) if steps is not None
             else ddim_step_list(min_noise, max_noise, ddim_step_size))
    if eta != 0.0 and generator is None and zs is None:
        raise ValueError("eta > 0 needs a generator (or injected zs)")
    device = x_t.device
    step_t = torch.tensor(steps, device=device)
    x = x_t.to(torch.float32)
    for i in range(len(steps) - 1):
        t, tm1 = step_t[i:i + 1], step_t[i + 1:i + 2]
        raw = model_fn(_concat_cond(x, cond_img), t, labels)
        abar_t = schedule.alpha_bar_at(t).to(torch.float32)
        eps_hat, x0_approx = _to_eps_x0(raw.to(torch.float32), x, abar_t)
        abar_tm1 = schedule.alpha_bar_at(tm1).to(torch.float32)
        if eta != 0.0:
            sigma = eta * (((1.0 - abar_tm1) / (1.0 - abar_t)) ** 0.5
                           * (1.0 - abar_t / abar_tm1) ** 0.5)
            noise = (zs[i].to(torch.float32) if zs is not None
                     else _randn(x.shape, x, generator))
            x = (abar_tm1 ** 0.5 * x0_approx
                 + (1.0 - abar_tm1 - sigma ** 2) ** 0.5 * eps_hat
                 + sigma * noise)
        else:
            x = (abar_tm1 ** 0.5 * x0_approx
                 + (1.0 - abar_tm1) ** 0.5 * eps_hat)

    # Final visited step: predict x0 once more.
    t_last = step_t[-1:]
    raw = model_fn(_concat_cond(x, cond_img), t_last, labels)
    abar_t = schedule.alpha_bar_at(t_last).to(torch.float32)
    _, x0_approx = _to_eps_x0(raw.to(torch.float32), x, abar_t)
    if steps[-1] == 1:
        return x0_approx
    return x


def cold_sample(model_fn: ModelFn, schedule, x_t: torch.Tensor,
                noise: torch.Tensor, *, min_noise: int = 1,
                max_noise: int = 1000, skip_step_size: int = 10,
                cond_img: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None,
                steps: Optional[List[int]] = None) -> torch.Tensor:
    """Cold-diffusion sampling with an x0-predicting model (sdm_tpu
    samplers.py:474-513). `noise` is the trajectory-shared degradation
    noise; `steps` overrides the uniform skip list, as in ddim_sample."""
    if str(getattr(model_fn, "model_output", "eps")).lower() == "v":
        raise ValueError(
            "cold_sample consumes x0-predicting models; the v "
            "parameterization applies to the eps family (ddpm/ddim/dpmpp)")
    steps = (list(steps) if steps is not None
             else ddim_step_list(min_noise, max_noise, skip_step_size))
    noise = noise.to(torch.float32)
    step_t = torch.tensor(steps, device=x_t.device)
    x = x_t.to(torch.float32)
    for i in range(len(steps) - 1):
        t, tm1 = step_t[i:i + 1], step_t[i + 1:i + 2]
        x0_hat = model_fn(_concat_cond(x, cond_img), t, labels)
        x0_hat = x0_hat.to(torch.float32)
        x = (x - schedule.q_sample(x0_hat, t, noise)
             + schedule.q_sample(x0_hat, tm1, noise))

    # Final step: the model's reconstruction.
    x0_hat = model_fn(_concat_cond(x, cond_img), step_t[-1:], labels)
    return x0_hat.to(torch.float32)
