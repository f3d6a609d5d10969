"""Progressive distillation (Salimans & Ho, ICLR 2022) for few-step DDIM
sampling (port of sdm_tpu/train/distill.py).

A student copy of an eps (or v) model learns to make ONE deterministic DDIM
step do what TWO teacher DDIM steps do; each phase halves the student's
grid again. With a_t = sqrt(abar_t), s_t = sqrt(1-abar_t), the teacher's
two steps t -> m -> u from x_t are

    eps1 = T(x_t, t);  x0_1 = (x_t - s_t eps1)/a_t;  x_m = a_m x0_1 + s_m eps1
    eps2 = T(x_m, m);  x0_2 = (x_m - s_m eps2)/a_m;  z   = a_u x0_2 + s_u eps2

and the student's one step from x_t to u lands on z iff its x0 prediction
is x~ = (z - (s_u/s_t) x_t) / (a_u - (s_u/s_t) a_t). The loss is
w(t) ||x0_student - x~||^2 with the truncated-SNR weight w =
max(abar/(1-abar), 1). The student trains on its own sampling grid,
`ddim_step_list(min, max, step_size)`, with the teacher's midpoint
m = (t+u)//2, plus the endpoint row t = m = u (the sampler's final x0
call), whose target is the teacher's own x0.

The teacher runs without a gradient; the student's forward and backward
run through the same kernels as the trainers. Each phase starts a fresh
Adam (the trainers' optimizer) and writes `distilled_ss{N}_{steps}.pt` in
the reference's checkpoint format, which sdm_tpu loads and which exports
and samples like any trained checkpoint. Random draws come from a
`torch.Generator`, so they are not sdm_tpu's numbers; tests inject "row"
and "eps" through the batch.

Data parallelism is the trainers' (train/loop.py): `num_devices` N > 1
spawns N ranks, the student runs under DistributedDataParallel inside a
process group, each rank's batch (and so its teacher calls) holds its
rows of the global batch, and its draws are its rows of the global draws
(`shard`). Rank 0 logs the mean loss over the ranks and writes the
checkpoints.
"""

from __future__ import annotations

import copy
import glob
import logging
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from sdm_tpu_torch.data import (ConditionalImgDataset, DataLoader,
                                DoodleImgDataset, ImageDataset)
from sdm_tpu_torch.diffusion.samplers import ddim_step_list
from sdm_tpu_torch.diffusion.vpred import _a_s
from sdm_tpu_torch.enums import Objective
from sdm_tpu_torch.io.checkpoint import (diffusion_checkpoint_dict,
                                         load_checkpoint,
                                         load_params_from_checkpoint,
                                         save_model)
from sdm_tpu_torch.models import UNet
from sdm_tpu_torch.ops.schedules import make_schedule
from sdm_tpu_torch.parallel import multihost as mh
from sdm_tpu_torch.parallel.mesh import (batch_positions, device_count,
                                         shard_rows)
from sdm_tpu_torch.train.loop import load_resident, train_device
from sdm_tpu_torch.train.step import (TrainState, begin_step,
                                      create_train_state, finish_step,
                                      make_optimizer)


def distill_pairs(step_list: List[int]) -> np.ndarray:
    """(P, 3) int32 rows (t, m, u): one row per student DDIM interval with
    the teacher midpoint m = (t+u)//2, plus the endpoint row (t=m=u=last
    step) for the sampler's final x0-extraction call."""
    rows = [(t, (t + u) // 2, u)
            for t, u in zip(step_list[:-1], step_list[1:])]
    last = step_list[-1]
    rows.append((last, last, last))
    return np.asarray(rows, dtype=np.int32)


@torch.no_grad()
def distill_target(apply_teacher: Callable, schedule, x_t: torch.Tensor,
                   t: torch.Tensor, m: torch.Tensor,
                   u: torch.Tensor) -> torch.Tensor:
    """The x0-space target x~ for per-sample steps (t, m, u); rows with
    t == u get the teacher's own x0 (the endpoint). No gradient reaches
    the teacher.

    `apply_teacher(x, t)` returns an eps prediction (x0 is then (x -
    s·eps)/a) or an `(eps, x0)` pair, which v-teachers compute natively
    (eps = a·v + s·x, x0 = a·x - s·v) so no step divides by a -> 0."""
    x_t = x_t.to(torch.float32)

    def eps_x0(x, tt, a, s):
        res = apply_teacher(x, tt)
        if isinstance(res, tuple):
            return tuple(r.to(torch.float32) for r in res)
        eps = res.to(torch.float32)
        return eps, (x - s * eps) / a

    a_t, s_t = _a_s(schedule, t, x_t)
    eps1, x0_1 = eps_x0(x_t, t, a_t, s_t)
    a_m, s_m = _a_s(schedule, m, x_t)
    x_m = a_m * x0_1 + s_m * eps1
    eps2, x0_2 = eps_x0(x_m, m, a_m, s_m)
    a_u, s_u = _a_s(schedule, u, x_t)
    z = a_u * x0_2 + s_u * eps2

    ratio = s_u / s_t
    denom = a_u - ratio * a_t          # == 0 exactly when t == u
    is_step = (t > u).reshape(t.shape + (1,) * (x_t.ndim - 1))
    safe_denom = torch.where(is_step, denom, torch.ones_like(denom))
    return torch.where(is_step, (z - ratio * x_t) / safe_denom, x0_1)


def make_distill_step(schedule, *, step_list: List[int],
                      objective: Optional[Objective] = None,
                      grad_clip_norm: Optional[float] = None,
                      shard=(0, 1)) -> Callable:
    """Build distill_step(state, teacher, batch, generator) -> {"loss":
    fp32 scalar tensor, not synchronized}: one Adam step of the student
    `state.model` against the module `teacher`. batch = {"image" [,
    "labels"] [, "cond_img"]} with the trainers' uint8-or-float pixels;
    tests may inject "row" (the pair index per sample) and "eps".

    objective=Objective.V distills a v-teacher into a v-student: both
    models' (eps, x0) come natively from v inside the same x0-space target
    math. grad_clip_norm is the trainers' direct pre-Adam clip. `shard` =
    (rank, world): the batch is rank's rows of a world-times larger global
    batch, and the row and eps draws are its rows of the global draws."""
    v_mode = objective == Objective.V
    rank, world = shard
    pairs_np = distill_pairs(step_list)
    n_rows = int(pairs_np.shape[0])
    pairs_on = {}

    def denorm(x):
        if x is not None and x.dtype == torch.uint8:
            return (x.to(torch.float32) - 127.5) / 127.5
        return x

    def loss_fn(student, teacher, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator]) -> torch.Tensor:
        images = denorm(batch["image"]).to(torch.float32)
        labels = batch.get("labels")
        cond_img = denorm(batch.get("cond_img"))
        n, dev = images.shape[0], images.device
        if dev not in pairs_on:
            pairs_on[dev] = torch.as_tensor(pairs_np, dtype=torch.int64,
                                            device=dev)
        pairs = pairs_on[dev]

        def cat(x):
            if cond_img is None:
                return x
            return torch.cat([x, cond_img.to(x.dtype)], dim=-1)

        def own(v):
            # This rank's rows of a draw over the global batch.
            return v if world == 1 else v[rank * n:(rank + 1) * n]

        if "row" in batch:
            i = batch["row"].to(dev, torch.int64)
        else:
            # Intervals uniform; the endpoint row (near-trivial, since the
            # student starts as the teacher) capped at 10 % of a batch.
            i = own(torch.randint(0, n_rows - 1, (n * world,),
                                  generator=generator, device=dev))
            endpoint_p = min(0.1, 1.0 / n_rows)
            at_end = own(torch.rand((n * world,), generator=generator,
                                    device=dev)) < endpoint_p
            i = torch.where(at_end, torch.full_like(i, n_rows - 1), i)
        t, m, u = pairs[i].unbind(-1)
        if "eps" in batch:
            eps = batch["eps"].to(dev, torch.float32)
        else:
            eps = own(torch.randn((n * world,) + images.shape[1:],
                                  generator=generator, device=dev))

        x_t = schedule.q_sample(images, t, eps)
        if v_mode:
            def teacher_fn(x, tt):
                v = teacher(cat(x), tt, labels).to(torch.float32)
                a, s = _a_s(schedule, tt, x)
                return a * v + s * x, a * x - s * v
        else:
            def teacher_fn(x, tt):
                return teacher(cat(x), tt, labels)
        x_tilde = distill_target(teacher_fn, schedule, x_t, t, m, u)

        out = student(cat(x_t), t, labels).to(torch.float32)
        a_t, s_t = _a_s(schedule, t, x_t)
        x0_hat = a_t * x_t - s_t * out if v_mode else (x_t - s_t * out) / a_t
        abar = schedule.alpha_bar_at(t).to(torch.float32)
        w = torch.clamp(abar / (1.0 - abar), min=1.0)   # truncated SNR
        per_sample = torch.mean(torch.square(x0_hat - x_tilde),
                                dim=tuple(range(1, x_t.ndim)))
        return torch.mean(w * per_sample)

    def distill_step(state: TrainState, teacher: torch.nn.Module,
                     batch: Dict[str, torch.Tensor],
                     generator: Optional[torch.Generator] = None):
        begin_step(state)
        loss = loss_fn(state.model, teacher, batch, generator)
        loss.backward()
        finish_step(state, grad_clip_norm)
        return {"loss": loss.detach()}

    distill_step.loss_fn = loss_fn
    return distill_step


def run_distillation(config_dict: dict, *, teacher_checkpoint: str,
                     start_step_size: Optional[int] = None,
                     phases: int = 2,
                     steps_per_phase: int = 2000,
                     distill_lr: Optional[float] = None,
                     num_devices: Optional[int] = None,
                     dataset_kind: str = "auto",
                     use_ema_teacher: bool = False,
                     log=logging.info, device="cuda") -> dict:
    """Drive `phases` halving phases from a trained eps (or v) checkpoint
    on `device` (CUDA unless the caller passes "cpu").

    `config_dict` is the reference-format training config (dataset, model,
    schedule, out_dir). The teacher samples well at DDIM step size
    `start_step_size` (default: the config's skip_step); phase p trains a
    student at start * 2^(p+1) and writes
    `out_dir/checkpoint/distilled_ss{N}_{steps}.pt`.

    Returns {"phase_step_sizes", "phase_losses", "model" (the last
    student), "state", "global_steps"}; a run that spawned its ranks
    (num_devices > 1, or more than one visible card dividing the batch)
    returns rank 0's without "model" and "state"."""
    dev = train_device(device)
    if not torch.distributed.is_initialized():
        n = device_count(dev, config_dict["batch_size"], num_devices)
        if n > 1:
            return mh.spawn(_spawned_distillation, n, dev.type, config_dict,
                            dict(teacher_checkpoint=teacher_checkpoint,
                                 start_step_size=start_step_size,
                                 phases=phases,
                                 steps_per_phase=steps_per_phase,
                                 distill_lr=distill_lr,
                                 dataset_kind=dataset_kind,
                                 use_ema_teacher=use_ema_teacher,
                                 device=dev.type))
    dev = train_device(dev)
    world, rank = mh.world(), mh.rank()
    if rank != 0:
        log = logging.debug
    objective = (Objective.V
                 if str(config_dict.get("objective", "")).upper() == "V"
                 else Objective.EPS)
    out_dir = config_dict["out_dir"]
    os.makedirs(out_dir, exist_ok=True)
    seed = int(config_dict.get("seed", 0))
    batch_size = config_dict["batch_size"]
    min_noise = config_dict["min_noise_step"]
    max_noise = config_dict["max_noise_step"]
    ss0 = int(start_step_size if start_step_size is not None
              else config_dict["skip_step"])
    if phases < 1:
        raise ValueError("phases must be >= 1")
    if ss0 < 1 or ss0 * 2 ** phases > max_noise - min_noise + 1:
        raise ValueError(
            f"start step size {ss0} halved {phases} times exceeds the "
            f"[{min_noise}, {max_noise}] trajectory")

    # The trainers' dataset rules; "doodle" reads image/doodle pairs.
    use_conditional = bool(config_dict.get("use_conditional"))
    cache = bool(config_dict.get("cache_dataset", False))
    dataset_path = config_dict["dataset_path"]
    if dataset_kind == "doodle":
        dataset = DoodleImgDataset(dataset_path=dataset_path, seed=seed,
                                   cache_decoded=cache, normalized=False)
    elif use_conditional or dataset_kind == "conditional":
        dataset = ConditionalImgDataset(dataset_path=dataset_path, seed=seed,
                                        cache_decoded=cache, normalized=False)
    else:
        img_list = glob.glob(dataset_path)
        if len(img_list) == 0:
            raise Exception("No dataset found!")
        dataset = ImageDataset(img_paths=img_list, cache_decoded=cache,
                               normalized=False)
    own = shard_rows(batch_size, rank, world)
    native_decode = bool(config_dict.get("native_decode", True))
    loader = DataLoader(dataset, batch_size=batch_size, shuffle=True,
                        num_workers=8, seed=seed, native_decode=native_decode,
                        rows=(batch_positions(batch_size, 1, rank, world)
                              if world > 1 else None))

    compute_dtype = {"bfloat16": torch.bfloat16, "float32": None,
                     "fp32": None, "bf16": torch.bfloat16}[
                         str(config_dict.get("compute_dtype",
                                             "bfloat16")).lower()]
    use_kernels = config_dict.get("use_pallas", "auto") is not False
    if use_kernels:
        mh.build_kernels_once(dev)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        teacher = UNet.from_config(config_dict, dtype=compute_dtype,
                                   use_kernels=use_kernels)
    beta_1 = config_dict.get("beta1", 5e-3)
    beta_T = config_dict.get("betaT", 9e-3)
    schedule = make_schedule(config_dict["noise_scheduler"],
                             beta_1=beta_1 if beta_1 is not None else 5e-3,
                             beta_T=beta_T if beta_T is not None else 9e-3,
                             max_noise_step=max_noise, device=dev)

    ok, ckpt = load_checkpoint(teacher_checkpoint, log=log)
    if not ok:
        raise Exception("An error occured while loading model checkpoint!")
    if use_ema_teacher and "ema" not in ckpt:
        raise ValueError(
            "use_ema_teacher: checkpoint carries no 'ema' key (train with "
            "config ema_decay to produce one)")
    load_params_from_checkpoint(ckpt, teacher, log=log,
                                key="ema" if use_ema_teacher else "model")
    del ckpt
    teacher = teacher.to(dev, memory_format=torch.channels_last)

    lr = float(distill_lr if distill_lr is not None
               else config_dict["diffusion_lr"])
    lr_steps = int(config_dict["lr_steps"])
    grad_clip_norm = config_dict.get("grad_clip_norm")
    if grad_clip_norm is not None:
        grad_clip_norm = float(grad_clip_norm)
        log(f"Gradient clipping (global L2 norm): {grad_clip_norm}")
    generator = torch.Generator(device=dev).manual_seed(seed)

    if bool(config_dict.get("device_dataset", False)):
        # The trainer's device-resident dataset (train/loop.py): one
        # transfer, then each step gathers its rows on the device from a
        # host permutation stream of its own seed (sdm_tpu distill.py:384).
        data = load_resident(dataset, dev, native_decode)
        n_rows = data["image"].shape[0]
        perm_rng = np.random.default_rng((seed + 0x51ED2705) % 2 ** 63)
        idx_buf = np.empty((0,), np.int64)
        nbytes = sum(v.numel() * v.element_size() for v in data.values())
        log(f"Device-resident dataset: {n_rows:,} rows "
            f"({nbytes / 2 ** 20:.1f} MiB) in device memory.")

        def next_batch():
            nonlocal idx_buf
            while idx_buf.size < batch_size:
                idx_buf = np.concatenate(
                    [idx_buf, perm_rng.permutation(n_rows)])
            idx, idx_buf = idx_buf[:batch_size], idx_buf[batch_size:]
            rows = torch.from_numpy(idx[own])
            if dev.type == "cuda":
                rows = rows.pin_memory()
            rows = rows.to(dev, non_blocking=True)
            return {k: v.index_select(0, rows) for k, v in data.items()}
    else:
        batch_iter = iter(loader)

        def next_batch():
            nonlocal batch_iter
            b = next(batch_iter, None)
            if b is None:
                batch_iter = iter(loader)
                b = next(batch_iter)
            return {k: torch.from_numpy(v).to(dev, non_blocking=True)
                    for k, v in b.items() if isinstance(v, np.ndarray)}

    phase_losses: List[float] = []
    phase_sizes: List[int] = []
    state = None
    global_steps = 0
    for p in range(phases):
        ss = ss0 * 2 ** (p + 1)
        step_list = ddim_step_list(min_noise, max_noise, ss)
        log(f"Distillation phase {p + 1}/{phases}: student step size {ss} "
            f"({len(step_list)} visited steps), teacher step size {ss // 2}")
        teacher.requires_grad_(False)
        student = copy.deepcopy(teacher).requires_grad_(True)
        optimizer, lr_schedule = make_optimizer(student.parameters(), lr,
                                                lr_steps)
        state = create_train_state(student, optimizer, lr_schedule)
        if torch.distributed.is_initialized():
            state.model = torch.nn.parallel.DistributedDataParallel(
                student, device_ids=[dev.index] if dev.type == "cuda"
                else None, find_unused_parameters=True)
        step_fn = make_distill_step(schedule, step_list=step_list,
                                    objective=objective,
                                    grad_clip_norm=grad_clip_norm,
                                    shard=(rank, world))

        total = float("nan")
        for i in range(steps_per_phase):
            metrics = step_fn(state, teacher, next_batch(), generator)
            global_steps += 1
            if (i + 1) % 50 == 0 or i + 1 == steps_per_phase:
                loss = metrics["loss"]
                if world > 1:
                    torch.distributed.all_reduce(loss)
                total = float(loss) / world
                if np.isnan(total):
                    raise Exception("NaN encountered during training")
                log("Phase {} | Steps: {:,} / {:,} | Distill: {:.6f}".format(
                    p + 1, i + 1, steps_per_phase, total))
        phase_losses.append(total)
        phase_sizes.append(ss)
        if rank == 0:
            save_model(diffusion_checkpoint_dict(student, optimizer, lr=lr),
                       f"distilled_ss{ss}", out_dir, checkpoint=True,
                       steps=global_steps, log=log)
        teacher = student  # the student becomes the next teacher

    mh.barrier("distill-end")
    return {"phase_step_sizes": phase_sizes, "phase_losses": phase_losses,
            "model": state.model, "state": state,
            "global_steps": global_steps}


def _spawned_distillation(config_dict, kwargs):
    if mh.rank() == 0:
        from sdm_tpu_torch.utils import setup_logging
        setup_logging(config_dict["out_dir"], "Distill-Diffusion")
    out = run_distillation(config_dict, **kwargs)
    return {k: v for k, v in out.items() if k not in ("model", "state")}
