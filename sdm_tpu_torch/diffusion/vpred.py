"""Velocity ("v") parameterization (port of sdm_tpu/diffusion/vpred.py;
Salimans & Ho 2022, eq. 9). With a_t = sqrt(abar_t), s_t = sqrt(1 - abar_t)
and x_t = a_t·x0 + s_t·eps:

    v   = a_t·eps − s_t·x0          (training target)
    eps = a_t·v + s_t·x_t           (exact inversion given x_t)
    x0  = a_t·x_t − s_t·v

Two routes, as in sdm_tpu:

  - NATIVE: `tag_v` marks a model_fn with `model_output = "v"`; the
    eps-family samplers (diffusion/samplers.py) read the tag and derive
    x0 = a·x − s·v and eps = a·v + s·x, both well-conditioned at every t.
    Bundles with "objective": "V" carry the tag (io/bundles.py).
  - ADAPTER: `as_eps_model` converts a v-model into the eps interface. The
    same algebra, but a later x0 = (x − s·eps)/a loses its precision as
    a → 0 (t = T under COSINE), which the native route avoids.

sdm_tpu's "factory" forms take params, which its jitted callers pass as an
argument; here they take the module (`factory(net) -> model_fn`).
"""

from __future__ import annotations

import torch


def _a_s(schedule, t, like: torch.Tensor):
    """(sqrt(abar_t), sqrt(1-abar_t)) in fp32 on `like`'s device, broadcast
    to its rank."""
    abar = schedule.alpha_bar_at(t).to(device=like.device,
                                       dtype=torch.float32)
    abar = abar.reshape(abar.shape + (1,) * (like.ndim - abar.ndim))
    return abar ** 0.5, (1.0 - abar) ** 0.5


def v_target(schedule, t, x0: torch.Tensor, eps: torch.Tensor
             ) -> torch.Tensor:
    """The regression target v = a·eps − s·x0 at per-sample steps t."""
    a, s = _a_s(schedule, t, x0)
    return a * eps - s * x0


def split_v(a, s, x_t: torch.Tensor, v: torch.Tensor):
    """(eps, x0) = (a·v + s·x_t, a·x_t − s·v), given a and s already."""
    return a * v + s * x_t, a * x_t - s * v


def eps_from_v(schedule, t, x_t: torch.Tensor, v: torch.Tensor
               ) -> torch.Tensor:
    return split_v(*_a_s(schedule, t, x_t), x_t, v)[0]


def x0_from_v(schedule, t, x_t: torch.Tensor, v: torch.Tensor
              ) -> torch.Tensor:
    return split_v(*_a_s(schedule, t, x_t), x_t, v)[1]


def tag_v(model_fn):
    """A pass-through wrapper of `model_fn` carrying `model_output = "v"`
    (the caller's callable stays unmutated)."""
    def v_fn(x, t, labels):
        return model_fn(x, t, labels)
    v_fn.model_output = "v"
    return v_fn


def tag_v_factory(model_fn_factory):
    """Factory-level `tag_v`: factory(net) -> tagged model_fn."""
    def factory(net):
        return tag_v(model_fn_factory(net))
    return factory


def as_eps_model(model_fn, schedule):
    """Wrap a v-predicting model_fn(x, t, labels) into the eps interface.
    `x` may carry concatenated conditioning channels (doodle/SR); only the
    leading out-channel block is x_t."""
    def eps_fn(x, t, labels):
        v = model_fn(x, t, labels).to(torch.float32)
        x_t = x[..., :v.shape[-1]].to(torch.float32)
        return eps_from_v(schedule, t, x_t, v)
    return eps_fn


def as_eps_factory(model_fn_factory, schedule):
    """Factory-level `as_eps_model`."""
    def factory(net):
        return as_eps_model(model_fn_factory(net), schedule)
    return factory
