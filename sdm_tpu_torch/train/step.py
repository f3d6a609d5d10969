"""The training step: q_sample -> forward -> fp32 MSE -> backward -> Adam
(port of sdm_tpu/train/step.py).

sdm_tpu fuses the step into one jitted XLA program; here it runs eagerly on
the model's device, and autograd differentiates through the kernels'
Functions (kernels/*.py). Objectives:

  EPS          eps-prediction, target = noise
  X0           x0-prediction, target = the clean image
  RESIDUAL_X0  SR residual, target = x_hr - up(down(x_hr)); the LR branch
               is q-sampled at the fixed `cond_t` with the SAME eps and
               channel-concatenated (step.py:224-231)
  V            velocity, target = a·eps − s·x0 (diffusion/vpred.py)

A batch's "cond_img" (the doodle trainer's conditioning image), under EPS
or X0, is normalized like "image", never flipped, and concatenated onto x_t
along channels (step.py:233-237).

t is drawn per sample from [min_noise_step, max_actual_noise_step), the high
end exclusive. Batches carry uint8 pixels, normalized on the device as
(x - 127.5) / 127.5. Tests inject "t" and "eps" through the batch. Random
draws (flip, t, eps, then the cfg_drop_prob label mask, in that order) come
from the caller's `torch.Generator`, so they are not sdm_tpu's numbers: a
seed gives the same run in the port, not the same draws as in JAX.

Adam is torch's, with betas (0.5, 0.999) and eps 1e-8; before each step the
learning rate is set to the schedule at the state's count, which starts at
the restored step (sdm_tpu seeds optax's schedule count the same way,
step.py:94-122). Parameters that get no gradient (the reference's dead
weights) get a zero one, so Adam updates and checkpoints every parameter as
optax does.

Extensions, each off by default (sdm_tpu step.py:143-173):
  grad_accum_steps A > 1  the batch arrives pre-split as (A, N/A, ...); A
      backward passes sum into the gradients, which are divided by A before
      the one Adam step; the loss is the mean of the micro-losses.
  cfg_drop_prob  each sample's labels become the zero (null) vector with
      this probability (diffusion/guidance.py::dropout_labels).
  ema_decay d  the state's `ema` (fp32 tensors beside the parameters) moves
      after each Adam step as e + (1-d)(p-e).
  min_snr_gamma g  per-sample weights with SNR = abar/(1-abar):
      min(SNR,g)/SNR for EPS, min(SNR,g)/(SNR+1) for V, min(SNR,g) for X0
      and RESIDUAL_X0.

Data parallelism (`shard=(rank, world)`, train/loop.py): the model is
wrapped in DistributedDataParallel (or sharded by FSDP2) and the batch
holds this rank's contiguous block of each global (micro-)batch. Every
rank draws the flips, t, eps and the label mask of the whole global
batch from the shared seeded generator and keeps its own rows, as
sdm_tpu draws one key over the global array and shards it: N ranks train
on the one-device run's draws. Under grad_accum_steps only the last
micro-batch's backward all-reduces the gradients (`no_sync`).

Spatial partitioning (`space`, a parallel/sp.py SpaceShard): the batch
holds whole images; the model input and the target are built at full
height, then cut to this rank's H slab, and the forward and backward run
inside sp.spatial(space). The loss is the slab's mean (min-SNR weights
are per sample), which the gradient average over the data x space ranks
turns into the one-device gradient (parallel/sp.py). Tensor parallelism
changes nothing here: the model's layers carry their shards.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from sdm_tpu_torch.diffusion.guidance import dropout_labels
from sdm_tpu_torch.diffusion.vpred import v_target
from sdm_tpu_torch.enums import Objective
from sdm_tpu_torch.ops.resize import area_resize
from sdm_tpu_torch.parallel import sp

Schedule = Callable[[int], float]
ADAM_BETAS = (0.5, 0.999)
ADAM_EPS = 1e-8


def reference_lr_schedule(base_lr: float, lr_steps: int) -> Schedule:
    """Halving every `lr_steps` global steps, after the step as the
    reference does: count c uses base_lr * 0.5 ** max(0, (c - 1) //
    lr_steps)."""
    def schedule(count: int) -> float:
        return float(base_lr) * 0.5 ** max(0, (int(count) - 1) // lr_steps)
    return schedule


def resume_lr_schedule(resume_lr: float, lr_steps: int,
                       resume_step: int) -> Schedule:
    """Continue from a restored optimizer's saved lr (torch's
    load_state_dict semantics): step resume_step + 1 sees exactly
    resume_lr, and each later lr_steps boundary halves it."""
    base_halvings = max(0, (resume_step - 1) // lr_steps)

    def schedule(count: int) -> float:
        halvings = max(0, (int(count) - 1) // lr_steps) - base_halvings
        return float(resume_lr) * 0.5 ** max(halvings, 0)
    return schedule


def make_optimizer(params, base_lr: float, lr_steps: int,
                   resume_lr: Optional[float] = None, resume_step: int = 0):
    """(Adam over `params`, its lr schedule): reference_lr_schedule, or
    resume_lr_schedule when resuming from a checkpointed lr."""
    schedule = (reference_lr_schedule(base_lr, lr_steps) if resume_lr is None
                else resume_lr_schedule(resume_lr, lr_steps, resume_step))
    opt = torch.optim.Adam(params, lr=schedule(resume_step),
                           betas=ADAM_BETAS, eps=ADAM_EPS)
    return opt, schedule


@dataclasses.dataclass
class TrainState:
    step: int                    # global steps completed
    model: torch.nn.Module       # fp32 parameters
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    count: int                   # the schedule's count (optax's)
    # EMA of the parameters ({name: fp32 tensor}, in parameter order), or
    # None when ema_decay is off.
    ema: Optional[Dict[str, torch.Tensor]] = None
    # The global gradient norm of the parameters' gradients (for
    # grad_clip_norm), where they are shards (parallel/tp.py); None: local.
    grad_norm: Optional[Callable] = None


def create_train_state(model, optimizer, schedule, step: int = 0,
                       ema: bool = False) -> TrainState:
    """A state at `step` (the restored global_steps); the schedule's count
    starts there, so a resumed run applies the lr it logs. `ema` starts
    the average at the model's parameters."""
    avg = ({name: p.detach().to(torch.float32).clone()
            for name, p in model.named_parameters()} if ema else None)
    return TrainState(step=int(step), model=model, optimizer=optimizer,
                      schedule=schedule, count=int(step), ema=avg)


def make_train_step(schedule, *, objective: Objective,
                    min_noise_step: int = 1,
                    max_actual_noise_step: int = 1000,
                    flip_imgs: bool = False,
                    cond_t: Optional[int] = None,
                    lr_dim: Optional[int] = None,
                    grad_accum_steps: int = 1,
                    cfg_drop_prob: float = 0.0,
                    ema_decay: Optional[float] = None,
                    min_snr_gamma: Optional[float] = None,
                    grad_clip_norm: Optional[float] = None,
                    shard: Tuple[int, int] = (0, 1),
                    space: Optional[sp.SpaceShard] = None) -> Callable:
    """Build train_step(state, batch, generator) -> {"loss": fp32 scalar
    tensor, not synchronized}. `schedule` is the noise schedule (on the
    model's device). batch: {"image": (N, H, W, C) uint8 or float [,
    "cond_img": (N, H, W, C') uint8 or float] [, "labels": (N, D)] [, "t":
    (N,)] [, "eps": (N, H, W, C)]} on the device; with grad_accum_steps A
    > 1 each entry carries a leading (A,) axis. `shard` = (rank, world):
    the batch is this rank's rows of a world-times larger global batch
    (world counts the data ranks). `space`: this rank's H slab."""
    if objective == Objective.RESIDUAL_X0 and (cond_t is None
                                               or lr_dim is None):
        raise ValueError("RESIDUAL_X0 objective needs cond_t and lr_dim")
    if grad_accum_steps < 1:
        raise ValueError("grad_accum_steps must be >= 1")
    rank, world = shard

    def denorm(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        if x is not None and x.dtype == torch.uint8:
            return (x.to(torch.float32) - 127.5) / 127.5
        return x

    def loss_fn(model, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator]) -> torch.Tensor:
        images = denorm(batch["image"]).to(torch.float32)
        labels = batch.get("labels")
        cond_img = denorm(batch.get("cond_img"))
        n = images.shape[0]
        dev = images.device

        def own(v):
            # This rank's rows of a draw over the global batch.
            return v if world == 1 else v[rank * n:(rank + 1) * n]

        if flip_imgs:
            # Per-image horizontal flip, p = 0.5 (W is axis 2 in NHWC).
            flip = own(torch.rand((n * world,), generator=generator,
                                  device=dev)) < 0.5
            images = torch.where(flip[:, None, None, None],
                                 images.flip(2), images)
        if "t" in batch:
            t = batch["t"].to(dev, torch.int64)
        else:
            t = own(torch.randint(min_noise_step, max_actual_noise_step,
                                  (n * world,), generator=generator,
                                  device=dev))
        if "eps" in batch:
            eps = batch["eps"].to(dev, torch.float32)
        else:
            eps = own(torch.randn((n * world,) + images.shape[1:],
                                  generator=generator, device=dev))
        labels = dropout_labels(labels, generator, cfg_drop_prob, shard)

        if objective == Objective.RESIDUAL_X0:
            h, w = images.shape[1], images.shape[2]
            lr_up = area_resize(area_resize(images, lr_dim, lr_dim), h, w)
            target = images - lr_up
            x_t = schedule.q_sample(images, t, eps)
            cond_t_vec = torch.tensor([cond_t], device=dev)
            x_t_lr = schedule.q_sample(lr_up, cond_t_vec, eps)
            x_in = torch.cat([x_t, x_t_lr], dim=-1)
        else:
            x_in = schedule.q_sample(images, t, eps)
            if cond_img is not None:
                x_in = torch.cat([x_in, cond_img.to(x_in.dtype)], dim=-1)
            if objective == Objective.EPS:
                target = eps
            elif objective == Objective.V:
                target = v_target(schedule, t, images, eps)
            else:
                target = images

        if space is not None:
            x_in, target = sp.slab(x_in, space), sp.slab(target, space)
        pred = model(x_in, t, labels)
        sq = torch.square(pred.to(torch.float32) - target)
        if min_snr_gamma is None:
            return torch.mean(sq)
        abar = schedule.alpha_bar_at(t).to(device=dev, dtype=torch.float32)
        snr = abar / (1.0 - abar)
        w = torch.clamp(snr, max=float(min_snr_gamma))
        if objective == Objective.EPS:
            w = w / snr
        elif objective == Objective.V:
            w = w / (snr + 1.0)
        return torch.mean(w * torch.mean(sq, dim=tuple(range(1, sq.ndim))))

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None):
        if (ema_decay is None) != (state.ema is None):
            raise ValueError(
                f"ema_decay={ema_decay} needs a state "
                + ("created with ema=True" if state.ema is None
                   else "without an EMA (create_train_state(ema=False))"))
        begin_step(state)
        with sp.spatial(space):
            if grad_accum_steps == 1:
                loss = loss_fn(state.model, batch, generator)
                loss.backward()
            else:
                loss = 0.0
                for a in range(grad_accum_steps):
                    with grad_sync(state.model, a == grad_accum_steps - 1):
                        micro = loss_fn(state.model,
                                        {k: v[a] for k, v in batch.items()},
                                        generator)
                        micro.backward()
                    loss = loss + micro.detach()
                loss = loss / grad_accum_steps
        finish_step(state, grad_clip_norm, grad_accum_steps)
        if ema_decay is not None:
            # e + (1-d)(p-e), with 1-d in fp32 as sdm_tpu computes it.
            torch._foreach_lerp_(list(state.ema.values()),
                                 [p.detach() for p in
                                  state.model.parameters()],
                                 float(np.float32(1.0)
                                       - np.float32(ema_decay)))
        return {"loss": loss.detach()}

    train_step.loss_fn = loss_fn
    return train_step


def grad_sync(model, sync: bool):
    """A context in which a DistributedDataParallel model's backward
    all-reduces the gradients only when `sync` (otherwise they accumulate
    locally, `no_sync`); any other model runs as it is."""
    if sync or not hasattr(model, "no_sync"):
        return contextlib.nullcontext()
    return model.no_sync()


def begin_step(state: TrainState) -> None:
    """The optimizer's lr set to the schedule at the state's count, and
    its gradients cleared, before a step's backward."""
    lr = state.schedule(state.count)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.zero_grad(set_to_none=True)


def finish_step(state: TrainState, grad_clip_norm: Optional[float] = None,
                grad_accum_steps: int = 1) -> None:
    """The Adam step on the gradients that the backward left: a zero one
    where a parameter got none, the sum of A micro-batches divided by A,
    then sdm_tpu's direct pre-Adam clip, scale = min(1, c / max(global
    norm, 1e-12)). The step and the schedule's count advance by one."""
    params = [p for group in state.optimizer.param_groups
              for p in group["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        elif grad_accum_steps > 1:
            p.grad.div_(grad_accum_steps)
    if grad_clip_norm is not None:
        gnorm = (state.grad_norm(params) if state.grad_norm is not None
                 else torch.linalg.vector_norm(torch.stack(
                     [torch.linalg.vector_norm(p.grad) for p in params])))
        scale = torch.clamp(float(grad_clip_norm)
                            / torch.clamp(gnorm, min=1e-12), max=1.0)
        for p in params:
            p.grad.mul_(scale)
    state.optimizer.step()
    state.step += 1
    state.count += 1
