"""Reverse-process samplers (port of sdm_tpu/diffusion/samplers.py). `lax.scan`
becomes a Python loop; the step indices and the per-step coefficients live
on the image's device, computed once before the loop in fp32, so a step
enqueues device work only.

Rules kept from sdm_tpu (and the reference diffusion_sampling_algorithms.py):
  - ddpm_sample: sigma_t = sqrt(beta_t); z only when t > 1;
    x_{t-1} = (1/sqrt(a)) (x_t - ((1-a)/sqrt(1-abar)) eps_hat) + sigma z.
  - ddim_sample: step list range(max, min-1, -size) with min appended when
    missed; eta = 0 by default; the final visit returns x0 when the last
    step is exactly 1, else x_t.
  - dpmpp_sample (DPM-Solver++(2M)) and heun_sample (Karras et al. 2022):
    the same step lists, return rule and ensemble chaining as ddim.
  - cold_sample: x0-predicting models, the noise shared by the trajectory.

`model_fn(x, t, labels)` takes NHWC x and a (1,) step tensor. A model_fn
carrying `model_output = "v"` (diffusion/vpred.py::tag_v) is consumed
natively by the eps family: eps = a·v + s·x, x0 = a·x − s·v. Noise comes
from an explicit `torch.Generator` or is injected (`zs`) for tests.

Inpainting (ddim, dpmpp, heun): where `inpaint_mask` is 1 the trajectory is
projected onto q_sample(inpaint_known, t, inpaint_noise) after every update,
and the final x0 is blended back to the known pixels.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from sdm_tpu_torch.diffusion.vpred import split_v

ModelFn = Callable[..., torch.Tensor]


def ddim_step_list(min_noise: int, max_noise: int, step_size: int
                   ) -> List[int]:
    """Skip-step schedule with the reference's append-min rule."""
    steps = list(range(max_noise, min_noise - 1, -step_size))
    if min_noise not in steps:
        steps = steps + [min_noise]
    return steps


def karras_step_list(min_noise: int, max_noise: int, n_steps: int,
                     schedule, rho: float = 7.0) -> List[int]:
    """Karras et al. (2022) rho-spaced step list on integer timesteps: the
    EDM noise level sigma(t) = sqrt(1-abar_t)/sqrt(abar_t), the grid

        sigma_i = (smax^(1/rho) + i/(n-1) (smin^(1/rho) - smax^(1/rho)))^rho

    each sigma_i snapped to the nearest t in log-sigma, deduplicated in
    order, the endpoints pinned to max_noise and min_noise."""
    if n_steps < 2:
        return [max_noise] if max_noise == min_noise else [max_noise,
                                                           min_noise]
    ts = np.arange(min_noise, max_noise + 1)
    abar = schedule.alpha_bar_at(torch.from_numpy(ts)).to(torch.float32)
    abar = abar.cpu().numpy().astype(np.float64)
    log_sig = 0.5 * (np.log1p(-abar) - np.log(abar))   # log sigma_edm(t)
    smin, smax = np.exp(log_sig[0]), np.exp(log_sig[-1])
    grid = np.linspace(0.0, 1.0, n_steps)
    sig = (smax ** (1.0 / rho)
           + grid * (smin ** (1.0 / rho) - smax ** (1.0 / rho))) ** rho
    # log_sig is increasing in t; snap each target to the nearest t.
    idx = np.abs(log_sig[None, :] - np.log(sig)[:, None]).argmin(axis=1)
    steps = [int(ts[i]) for i in idx]
    steps[0], steps[-1] = max_noise, min_noise
    out: List[int] = []
    for s in steps:
        if not out or s < out[-1]:
            out.append(s)
    return out


def karras_steps_matching(min_noise: int, max_noise: int, step_size: int,
                          schedule, rho: float = 7.0) -> List[int]:
    """The Karras list with as many steps as ddim_step_list(min_noise,
    max_noise, step_size): the spacing swap behind --karras."""
    n_steps = len(ddim_step_list(min_noise, max_noise, step_size))
    return karras_step_list(min_noise, max_noise, n_steps, schedule, rho=rho)


def _concat_cond(x: torch.Tensor, cond_img: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    if cond_img is None:
        return x
    return torch.cat([x, cond_img.to(x.dtype)], dim=-1)


def _model_output(model_fn: ModelFn) -> str:
    """"eps" (default) or "v" (vpred.tag_v)."""
    mo = str(getattr(model_fn, "model_output", "eps")).lower()
    if mo not in ("eps", "v"):
        raise ValueError(f"unsupported model_output tag {mo!r} "
                         "(expected 'eps' or 'v')")
    return mo


def _to_eps_x0(raw: torch.Tensor, x: torch.Tensor, abar_t: torch.Tensor,
               model_output: str):
    """(eps_hat, x0_hat) in fp32: an eps model keeps the reference's
    x0 = (x - s eps)/a; a v model takes x0 = a x - s v, eps = a v + s x."""
    s = (1.0 - abar_t) ** 0.5
    if model_output == "v":
        return split_v(abar_t ** 0.5, s, x, raw)
    return raw, (x - s * raw) / abar_t ** 0.5


def _inpaint_ctx(inpaint_known, inpaint_mask, inpaint_noise):
    """(known, mask, noise) in fp32, or None when inpainting is off."""
    if inpaint_known is None:
        return None
    if inpaint_mask is None or inpaint_noise is None:
        raise ValueError(
            "inpainting needs inpaint_known, inpaint_mask AND "
            "inpaint_noise together")
    return (inpaint_known.to(torch.float32), inpaint_mask.to(torch.float32),
            inpaint_noise.to(torch.float32))


def _inpaint_project(ctx, schedule, x_new, t):
    """The known region onto its forward marginal at step `t`."""
    known, mask, pnoise = ctx
    return (1.0 - mask) * x_new + mask * schedule.q_sample(known, t, pnoise)


def _inpaint_finalize(ctx, schedule, x0_approx, x_t, t_last):
    """The final x0 blended to the known pixels, and x_t kept projected so
    ensemble chaining stays consistent with the known region."""
    known, mask, _ = ctx
    x0_approx = (1.0 - mask) * x0_approx + mask * known
    return x0_approx, _inpaint_project(ctx, schedule, x_t, t_last)


def _finish(model_fn, schedule, x, steps, step_t, cond_img, labels, mo,
            ink):
    """The final visited step of ddim, dpmpp and heun: x0 once more, and
    it is returned when the last step is exactly 1, else x_t."""
    t_last = step_t[-1:]
    raw = model_fn(_concat_cond(x, cond_img), t_last, labels)
    abar_t = schedule.alpha_bar_at(t_last).to(torch.float32)
    _, x0_approx = _to_eps_x0(raw.to(torch.float32), x, abar_t, mo)
    if ink is not None:
        x0_approx, x = _inpaint_finalize(ink, schedule, x0_approx, x, t_last)
    return x0_approx if steps[-1] == 1 else x


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
    mo = _model_output(model_fn)
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
        eps_hat, _ = _to_eps_x0(raw.to(torch.float32), x, alpha_bar, mo)
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
                inpaint_known: Optional[torch.Tensor] = None,
                inpaint_mask: Optional[torch.Tensor] = None,
                inpaint_noise: Optional[torch.Tensor] = None,
                steps: Optional[List[int]] = None) -> torch.Tensor:
    """DDIM sampling (eta = 0 deterministic by default). For eta > 0 the
    per-step noise comes from `generator` or is injected via `zs`
    (len(steps) - 1, *x.shape)."""
    mo = _model_output(model_fn)
    steps = (list(steps) if steps is not None
             else ddim_step_list(min_noise, max_noise, ddim_step_size))
    if eta != 0.0 and generator is None and zs is None:
        raise ValueError("eta > 0 needs a generator (or injected zs)")
    ink = _inpaint_ctx(inpaint_known, inpaint_mask, inpaint_noise)
    step_t = torch.tensor(steps, device=x_t.device)
    x = x_t.to(torch.float32)
    for i in range(len(steps) - 1):
        t, tm1 = step_t[i:i + 1], step_t[i + 1:i + 2]
        raw = model_fn(_concat_cond(x, cond_img), t, labels)
        abar_t = schedule.alpha_bar_at(t).to(torch.float32)
        eps_hat, x0_approx = _to_eps_x0(raw.to(torch.float32), x, abar_t, mo)
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
        if ink is not None:
            x = _inpaint_project(ink, schedule, x, tm1)
    return _finish(model_fn, schedule, x, steps, step_t, cond_img, labels,
                   mo, ink)


def _schedule_coefs(schedule, step_t: torch.Tensor):
    """(abar, alpha, sigma) of the step list, fp32, on step_t's device."""
    abar = schedule.alpha_bar_at(step_t).to(device=step_t.device,
                                            dtype=torch.float32)
    return abar, abar ** 0.5, (1.0 - abar) ** 0.5


def dpmpp_sample(model_fn: ModelFn, schedule, x_t: torch.Tensor, *,
                 min_noise: int = 1, max_noise: int = 1000,
                 step_size: int = 100,
                 cond_img: Optional[torch.Tensor] = None,
                 labels: Optional[torch.Tensor] = None,
                 steps: Optional[List[int]] = None,
                 inpaint_known: Optional[torch.Tensor] = None,
                 inpaint_mask: Optional[torch.Tensor] = None,
                 inpaint_noise: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """DPM-Solver++(2M) (Lu et al. 2022), deterministic, one model call per
    step. With alpha_t = sqrt(abar_t), sigma_t = sqrt(1-abar_t),
    lambda_t = log(alpha_t/sigma_t), h_i = lambda_{t_i} - lambda_{t_{i-1}}:

        D_i     = (1 + c_i) x0_i - c_i x0_{i-1},   c_i = h_i / (2 h_{i-1})
        x_{t_i} = (sigma_{t_i}/sigma_{t_{i-1}}) x_{t_{i-1}}
                  - alpha_{t_i} (e^{-h_i} - 1) D_i

    (c_0 = 0: the first step is first order, DDIM's)."""
    mo = _model_output(model_fn)
    steps = (list(steps) if steps is not None
             else ddim_step_list(min_noise, max_noise, step_size))
    ink = _inpaint_ctx(inpaint_known, inpaint_mask, inpaint_noise)
    step_t = torch.tensor(steps, device=x_t.device)
    abar, alpha, sigma = _schedule_coefs(schedule, step_t)
    lam = torch.log(alpha / sigma)
    h = lam[1:] - lam[:-1]                       # (n-1,), > 0
    c = torch.cat([torch.zeros_like(h[:1]), h[1:] / (2.0 * h[:-1])])
    sig_ratio = sigma[1:] / sigma[:-1]
    gain = alpha[1:] * (1.0 - torch.exp(-h))     # -alpha_t (e^{-h} - 1)

    x = x_t.to(torch.float32)
    x0_prev = torch.zeros_like(x)
    for i in range(len(steps) - 1):
        raw = model_fn(_concat_cond(x, cond_img), step_t[i:i + 1], labels)
        _, x0 = _to_eps_x0(raw.to(torch.float32), x, abar[i:i + 1], mo)
        d = (1.0 + c[i]) * x0 - c[i] * x0_prev
        x = sig_ratio[i] * x + gain[i] * d
        if ink is not None:
            x = _inpaint_project(ink, schedule, x, step_t[i + 1:i + 2])
        x0_prev = x0
    return _finish(model_fn, schedule, x, steps, step_t, cond_img, labels,
                   mo, ink)


def heun_sample(model_fn: ModelFn, schedule, x_t: torch.Tensor, *,
                min_noise: int = 1, max_noise: int = 1000,
                step_size: int = 100,
                cond_img: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None,
                steps: Optional[List[int]] = None,
                inpaint_known: Optional[torch.Tensor] = None,
                inpaint_mask: Optional[torch.Tensor] = None,
                inpaint_noise: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """Heun's 2nd-order predictor-corrector on the probability-flow ODE
    (Karras et al. 2022, Algorithm 1), two model calls per transition:

        x~      = r x + g eps_hat(x, t)             (the DDIM predictor)
        x_{t'}  = r x + g (eps_hat(x, t) + eps_hat(x~, t')) / 2

    with r = alpha_{t'}/alpha_t and g = sigma_{t'} - r sigma_t."""
    mo = _model_output(model_fn)
    steps = (list(steps) if steps is not None
             else ddim_step_list(min_noise, max_noise, step_size))
    ink = _inpaint_ctx(inpaint_known, inpaint_mask, inpaint_noise)
    step_t = torch.tensor(steps, device=x_t.device)
    abar, alpha, sigma = _schedule_coefs(schedule, step_t)
    r = alpha[1:] / alpha[:-1]
    g = sigma[1:] - r * sigma[:-1]

    x = x_t.to(torch.float32)
    for i in range(len(steps) - 1):
        raw = model_fn(_concat_cond(x, cond_img), step_t[i:i + 1], labels)
        eps1, _ = _to_eps_x0(raw.to(torch.float32), x, abar[i:i + 1], mo)
        x_pred = r[i] * x + g[i] * eps1
        raw2 = model_fn(_concat_cond(x_pred, cond_img), step_t[i + 1:i + 2],
                        labels)
        eps2, _ = _to_eps_x0(raw2.to(torch.float32), x_pred,
                             abar[i + 1:i + 2], mo)
        x = r[i] * x + g[i] * 0.5 * (eps1 + eps2)
        if ink is not None:
            x = _inpaint_project(ink, schedule, x, step_t[i + 1:i + 2])
    return _finish(model_fn, schedule, x, steps, step_t, cond_img, labels,
                   mo, ink)


def cold_sample(model_fn: ModelFn, schedule, x_t: torch.Tensor,
                noise: torch.Tensor, *, min_noise: int = 1,
                max_noise: int = 1000, skip_step_size: int = 10,
                cond_img: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None,
                steps: Optional[List[int]] = None) -> torch.Tensor:
    """Cold-diffusion sampling with an x0-predicting model (sdm_tpu
    samplers.py:474-513). `noise` is the trajectory-shared degradation
    noise; `steps` overrides the uniform skip list, as in ddim_sample."""
    if _model_output(model_fn) == "v":
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
