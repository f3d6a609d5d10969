"""Rank bodies for tests/test_torch_parallel.py and
tests/test_torch_parallel_loop.py (no test here; torch only, so a spawned
rank starts without JAX).

Each rank runs its part inside a two-rank gloo group and writes what the
parent compares to `<tmp>/<name>_rank<r>.pt`.
"""

import os

import torch
import torch.distributed as dist

from sdm_tpu_torch.enums import Objective
from sdm_tpu_torch.models import UNet
from sdm_tpu_torch.ops.schedules import make_schedule
from sdm_tpu_torch.parallel import fsdp
from sdm_tpu_torch.parallel.mesh import make_mesh, shard_batch
from sdm_tpu_torch.train import step as port_step

# tests/test_fsdp.py's U-Net.
FSDP_UNET = dict(num_resnet_blocks=1, in_channel=3, out_channel=3,
                 time_dim=16, cond_dim=None, num_layers=2, attn_layers=(1,),
                 num_heads=1, dim_per_head=None, groups=32, min_channel=128,
                 max_channel=256, image_recon=False)
LR, LR_STEPS = 1e-3, 100_000


def _save(tmp, name, value):
    torch.save(value, os.path.join(tmp, f"{name}_rank{dist.get_rank()}.pt"))


def _global_mean(loss):
    loss = loss.detach().clone()
    dist.all_reduce(loss)
    return float(loss) / dist.get_world_size()


def _unet(state_dict):
    net = UNet(**FSDP_UNET)
    net.load_state_dict(state_dict, strict=True)
    return net


def _one_step(net, model, batch):
    optimizer, schedule = port_step.make_optimizer(net.parameters(), LR,
                                                   LR_STEPS)
    state = port_step.create_train_state(net, optimizer, schedule)
    state.model = model
    noise = make_schedule("LINEAR", beta_1=5e-3, beta_T=9e-3,
                          max_noise_step=1000)
    step = port_step.make_train_step(
        noise, objective=Objective.EPS, min_noise_step=1,
        max_actual_noise_step=1000,
        shard=(dist.get_rank(), dist.get_world_size()))
    return step(state, batch)["loss"], optimizer


def step_worker(tmp):
    """One train step of tests/test_fsdp.py's U-Net on this rank's rows of
    the injected batch, under DDP, then under FSDP2 (min_size 2**12)."""
    inputs = torch.load(os.path.join(tmp, "step_inputs.pt"))
    rank, world = dist.get_rank(), dist.get_world_size()
    batch = shard_batch(inputs["batch"], rank, world)

    net = _unet(inputs["params"])
    ddp = torch.nn.parallel.DistributedDataParallel(
        net, find_unused_parameters=True)
    loss, _ = _one_step(net, ddp, batch)
    out = {"ddp_loss": _global_mean(loss),
           "ddp_params": {k: v.detach().clone()
                          for k, v in net.state_dict().items()}}

    net = _unet(inputs["params"])
    full_bytes = 3 * sum(p.numel() * p.element_size()
                         for p in net.parameters())
    fsdp.shard_model(net, make_mesh("cpu"), min_size=2 ** 12)
    loss, optimizer = _one_step(net, net, batch)
    out["fsdp_loss"] = _global_mean(loss)
    out["fsdp_bytes"] = fsdp.state_bytes_per_device(net, optimizer)
    out["full_bytes"] = full_bytes
    out["fsdp_checkpoint"] = fsdp.checkpoint_dict(net, optimizer, LR)
    _save(tmp, "step", out)


def loop_worker(tmp):
    """The trainer and the distiller inside one two-rank group (joined
    through the SDM_* env by the first run): the multi-host run, then
    one-command-mode runs (DDP, FSDP, grad accumulation) and one
    distillation step."""
    from sdm_tpu_torch.train import distill, loop
    cfgs = torch.load(os.path.join(tmp, "loop_inputs.pt"))
    out = {}
    for name, cfg in cfgs["runs"].items():
        if name != "multihost":
            os.environ.pop("SDM_COORDINATOR_ADDRESS", None)
        summary = loop.run_training(loop.BASE_SPEC, cfg, device="cpu",
                                    max_steps=cfgs["steps"])
        net = summary["state"].model
        net = getattr(net, "module", net)
        params = {k: (v.full_tensor() if hasattr(v, "full_tensor") else v)
                  .detach().clone() for k, v in net.state_dict().items()}
        out[name] = dict(params=params, steps=summary["global_steps"],
                         loss=summary["last_loss"],
                         world=dist.get_world_size())

    d = cfgs["distill"]
    rank, world = dist.get_rank(), dist.get_world_size()
    teacher = UNet.from_config(d["config"], dtype=None)
    teacher.load_state_dict(d["teacher"], strict=True)
    student = UNet.from_config(d["config"], dtype=None)
    student.load_state_dict(d["student"], strict=True)
    teacher.requires_grad_(False)
    optimizer, schedule = port_step.make_optimizer(student.parameters(),
                                                   d["lr"], 100)
    state = port_step.create_train_state(student, optimizer, schedule)
    state.model = torch.nn.parallel.DistributedDataParallel(
        student, find_unused_parameters=True)
    noise = make_schedule("LINEAR", beta_1=5e-3, beta_T=9e-3,
                          max_noise_step=d["config"]["max_noise_step"])
    step = distill.make_distill_step(noise, step_list=d["step_list"],
                                     shard=(rank, world))
    batch = shard_batch(d["batch"], rank, world)
    loss = step(state, teacher, batch)["loss"]
    out["distill"] = dict(loss=_global_mean(loss),
                          params={k: v.detach().clone() for k, v in
                                  student.state_dict().items()})
    _save(tmp, "loop", out)


def sdm_env_entry(local_rank, address, tmp):
    """A rank launched as sdm_tpu's explicit multi-host contract describes
    it: SDM_COORDINATOR_ADDRESS, SDM_NUM_PROCESSES and SDM_PROCESS_ID set,
    no group yet (the trainer joins one), two CPU threads."""
    torch.set_num_threads(2)
    os.environ.update(SDM_COORDINATOR_ADDRESS=address, SDM_NUM_PROCESSES="2",
                      SDM_PROCESS_ID=str(local_rank))
    try:
        loop_worker(tmp)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
