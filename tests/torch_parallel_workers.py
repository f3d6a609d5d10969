"""Rank bodies for tests/test_torch_parallel.py,
tests/test_torch_parallel_loop.py and tests/test_torch_model_parallel.py
(no test here; torch only, so a spawned rank starts without JAX).

Each rank runs its part inside a gloo group (two ranks, four for the model
-parallel body) and writes what the parent compares to
`<tmp>/<name>_rank<r>.pt`.
"""

import os

import torch
import torch.distributed as dist

from sdm_tpu_torch.enums import Objective
from sdm_tpu_torch.models import UNet
from sdm_tpu_torch.ops.schedules import make_schedule
from sdm_tpu_torch.parallel import fsdp, tp
from sdm_tpu_torch.parallel.mesh import make_mesh, shard_batch
from sdm_tpu_torch.train import step as port_step

# tests/test_fsdp.py's U-Net.
FSDP_UNET = dict(num_resnet_blocks=1, in_channel=3, out_channel=3,
                 time_dim=16, cond_dim=None, num_layers=2, attn_layers=(1,),
                 num_heads=1, dim_per_head=None, groups=32, min_channel=128,
                 max_channel=256, image_recon=False)
LR, LR_STEPS = 1e-3, 100_000
# tests/test_tp.py's U-Net is FSDP_UNET; tests/test_sp.py's, and its
# attention-heavy config (test_sp_attention_work_not_replicated).
SP_UNET = dict(FSDP_UNET, min_channel=32, max_channel=64)
SP_ATTN_UNET = dict(SP_UNET, attn_layers=(0, 1), groups=8, min_channel=16,
                    max_channel=32)
# The four-rank layouts: (tp, sp) (dp = 4 / (tp * sp)).
MP_LAYOUTS = {"dp2_tp2": (2, 1), "dp2_sp2": (1, 2), "tp2_sp2": (2, 2)}
TP_MIN_WIDTH = 32


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
    out["fsdp_checkpoint"] = tp.checkpoint_dict(net, optimizer, LR, None,
                                                 {}, None)
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


def _mp_model(cfg, state_dict, tp_n, sp_n, mesh):
    """The U-Net of `cfg` with `state_dict`, its wide weights sharded over
    the model group, under DDP over the data x space ranks (kernels off
    under SP, as the trainers build it)."""
    from sdm_tpu_torch.parallel import _comm
    net = UNet(**cfg, use_kernels=sp_n == 1)
    net.load_state_dict(state_dict, strict=True)
    names = (tp.shard_model(net, mesh.model_group, TP_MIN_WIDTH)
             if tp_n > 1 else {})
    return net, names, _comm.data_parallel(net, torch.device("cpu"),
                                           mesh.reduce_group,
                                           count_bytes=True)


def _fsdp_mp_model(cfg, state_dict, tp_n, sp_n, mesh):
    """The U-Net of `cfg` with `state_dict`, its wide weights sharded over
    the model group, then FSDP2 over the data ranks (the space ranks as
    replicas), as the trainers compose them with "fsdp"; with the group
    FSDP2 shards over."""
    from sdm_tpu_torch.parallel.mesh import fsdp_mesh
    net = UNet(**cfg, use_kernels=sp_n == 1)
    net.load_state_dict(state_dict, strict=True)
    names = (tp.shard_model(net, mesh.model_group, TP_MIN_WIDTH)
             if tp_n > 1 else {})
    data = fsdp_mesh(mesh)
    fsdp.shard_model(net, data, min_size=2 ** 12, tp_dims=names)
    return net, names, data.get_group(data.ndim - 1)


def _mp_step_fn(mesh, sp_n):
    from sdm_tpu_torch.parallel.sp import SpaceShard
    noise = make_schedule("LINEAR", beta_1=5e-3, beta_T=9e-3,
                          max_noise_step=1000)
    return port_step.make_train_step(
        noise, objective=Objective.EPS, min_noise_step=1,
        max_actual_noise_step=1000, shard=(mesh.data, mesh.dp),
        space=(SpaceShard(mesh.space_group, mesh.space, sp_n) if sp_n > 1
               else None))


def _work(model, step, batch, space=None):
    """(flops by op, total flops, bytes saved for the backward) of one
    forward and backward of the training loss."""
    from torch.utils.flop_counter import FlopCounterMode
    from sdm_tpu_torch.parallel import sp
    saved = {}

    def pack(t):
        saved[(t.data_ptr(), tuple(t.shape))] = t.numel() * t.element_size()
        return t
    counter = FlopCounterMode(display=False)
    with sp.spatial(space), counter:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = step.loss_fn(model, batch, None)
        loss.backward()
    by_op = {str(k): v for k, v in counter.get_flop_counts()["Global"]
             .items()}
    return by_op, counter.get_total_flops(), sum(saved.values())


def _conv_flops(by_op):
    return sum(v for k, v in by_op.items() if "convolution" in k)


def model_parallel_worker(tmp):
    """On a four-rank group: one train step of each MP_LAYOUTS layout
    (their global loss, gathered parameters and collective bytes); TP's
    state bytes and conv work per rank and SP's work and saved bytes per
    rank, each beside the same rows on one device; a pure-DP step's
    collective bytes, and the same step under FSDP2 composed with the
    layout; then the trainer runs of `mp_inputs.pt`."""
    from sdm_tpu_torch.parallel import _comm, analysis
    from sdm_tpu_torch.parallel.mesh import make_model_mesh, shard_rows
    from sdm_tpu_torch.parallel.sp import SpaceShard
    from sdm_tpu_torch.train import loop
    inputs = torch.load(os.path.join(tmp, "mp_inputs.pt"))
    out = {}
    for name, (tp_n, sp_n) in MP_LAYOUTS.items():
        case = inputs["steps"][name]
        mesh = make_model_mesh("cpu", tp_n, sp_n)
        net, names, ddp = _mp_model(case["unet"], case["params"], tp_n, sp_n,
                                    mesh)
        rows = shard_rows(case["batch"]["image"].shape[0], mesh.data,
                          mesh.dp)
        batch = {k: v[rows] for k, v in case["batch"].items()}
        optimizer, schedule = port_step.make_optimizer(net.parameters(), LR,
                                                       LR_STEPS)
        state = port_step.create_train_state(net, optimizer, schedule)
        state.model = ddp
        step = _mp_step_fn(mesh, sp_n)
        metrics = {}
        comm = analysis.step_collective_bytes(
            lambda: metrics.update(step(state, batch)))
        params = {k: (_comm.all_gather(v.detach(), mesh.model_group,
                                       names[k]) if k in names
                      else v.detach()).clone()
                  for k, v in net.state_dict().items()}
        out[name] = dict(loss=_global_mean(metrics["loss"]), params=params,
                         comm=comm, sharded=sorted(names))
        # The same step with FSDP2 over the data ranks in place of DDP.
        fnet, fnames, data_group = _fsdp_mp_model(
            case["unet"], case["params"], tp_n, sp_n, mesh)
        fopt, schedule = port_step.make_optimizer(fnet.parameters(), LR,
                                                  LR_STEPS)
        fstate = port_step.create_train_state(fnet, fopt, schedule)
        loss = step(fstate, batch)["loss"]
        out[f"fsdp_step_{name}"] = dict(
            loss=_global_mean(loss), params=tp.gather_whole(
                fnet.state_dict(), fnames, mesh.model_group))
        if fnames:
            # The norm from FSDP2's shards of the TP shards.
            out[f"fsdp_step_{name}"]["grad_norm"] = float(tp.grad_norm_fn(
                fnet, fnames, mesh.model_group, data_group)(
                    list(fnet.parameters())))
        if names:
            # The global gradient norm (grad_clip_norm) from the shards,
            # against the norm of the gathered gradients.
            grads = [p for p in net.parameters() if p.grad is not None]
            whole = [(_comm.all_gather(p.grad, mesh.model_group, names[n])
                      if n in names else p.grad)
                     for n, p in net.named_parameters() if p.grad is not None]
            out[name]["grad_norm"] = (
                float(tp.grad_norm_fn(net, names, mesh.model_group)(grads)),
                float(torch.sqrt(sum(g.float().square().sum()
                                     for g in whole))))
        if name == "dp2_tp2":
            full = _unet(case["params"])
            out["tp_work"] = dict(
                state=fsdp.state_bytes_per_device(net, optimizer),
                full_state=3 * sum(p.numel() * p.element_size()
                                   for p in full.parameters()),
                conv=_conv_flops(_work(ddp, step, batch)[0]),
                full_conv=_conv_flops(_work(
                    full, _mp_step_fn(mesh, 1), batch)[0]))
        if name == "dp2_sp2":
            work = inputs["sp_work"]
            rows = shard_rows(work["batch"]["image"].shape[0], mesh.data,
                              mesh.dp)
            wbatch = {k: v[rows] for k, v in work["batch"].items()}
            net, _, ddp = _mp_model(work["unet"], work["params"], 1, sp_n,
                                    mesh)
            one = UNet(**work["unet"], use_kernels=False)
            one.load_state_dict(work["params"], strict=True)
            _, flops, saved = _work(
                ddp, step, wbatch,
                SpaceShard(mesh.space_group, mesh.space, sp_n))
            _, full_flops, full_saved = _work(one, _mp_step_fn(mesh, 1),
                                              wbatch)
            out["sp_work"] = dict(flops=flops, full_flops=full_flops,
                                  saved=saved, full_saved=full_saved)

    # Pure DP over the four ranks.
    case = inputs["steps"]["dp2_tp2"]
    mesh = make_model_mesh("cpu", 1, 1)
    net, _, ddp = _mp_model(case["unet"], case["params"], 1, 1, mesh)
    rows = shard_rows(case["batch"]["image"].shape[0], mesh.data, mesh.dp)
    optimizer, schedule = port_step.make_optimizer(net.parameters(), LR,
                                                   LR_STEPS)
    state = port_step.create_train_state(net, optimizer, schedule)
    state.model = ddp
    out["dp4_comm"] = analysis.step_collective_bytes(
        _mp_step_fn(mesh, 1), state,
        {k: v[rows] for k, v in case["batch"].items()})
    out["param_bytes"] = sum(p.numel() * p.element_size()
                             for p in net.parameters())

    for name, (spec, cfg) in inputs["runs"].items():
        summary = loop.run_training(getattr(loop, spec), cfg, device="cpu",
                                    max_steps=inputs["max_steps"].get(name,
                                                                      2))
        out[name] = dict(loss=summary["last_loss"],
                         steps=summary["global_steps"])
    _save(tmp, "mp", out)
