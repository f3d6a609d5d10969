"""Tensor parallelism over the "model" axis (port of sdm_tpu/parallel/
tp.py, config "tp" and "tp_min_width").

sdm_tpu shards every conv or dense kernel whose output-channel dim (its
last) is at least `min_width` and divides by tp over a "model" mesh axis
and lets GSPMD insert the collectives; its kernels' partitioning rule
(sdm_tpu/kernels/partitioning.py) marks every non-batch dim
need-replication, so AdaGN and attention run on gathered, whole-channel
tensors. Here the same rule (`sharded_names`) picks the same weights, and
each picked layer becomes column-parallel (`column`): its input enters
through CopyToGroup, the rank computes only its own output channels with
its weight shard, and GatherFromGroup concatenates the channels, after
which the bias is added whole. So conv and linear work per rank falls to
about 1/tp on the sharded layers, and everything between them (AdaGN,
attention, the kernels) runs replicated at its one-device shape. An
attention block hands whole weights to `fused_attention_block`
(`full_weight` gathers them); q, k and v are never split.

The JAX last dim of a kernel is the port's weight dim 0 for Conv2d and
Linear and dim 1 for ConvTranspose2d (io/interop.py), which the layers
declare as `tp_out_dim`. Biases and norms stay whole on every rank; Adam
moments and the EMA follow their parameters. Checkpoints gather the whole
state to rank 0 in the unsharded format (`checkpoint_dict`, a
collective), and a resume cuts a whole state into this rank's shards
(`shard_tree`). "fsdp" shards these local shards again over the data
ranks (parallel/fsdp.py), whose DTensors the gathers and the norm take
too; a native checkpoint (io/native_ckpt.py) sees each shard as the
DTensor of its whole tensor (`as_global`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from sdm_tpu_torch.parallel import _comm


@dataclasses.dataclass(frozen=True)
class ColumnShard:
    """A layer's shard: its weight holds output channels [rank*n,
    (rank+1)*n) of `dim` within `group` (of `size` ranks)."""
    group: object
    rank: int
    size: int
    dim: int


@dataclasses.dataclass(frozen=True)
class StateShards:
    """Where a tensor-parallel run's state lies: the sharded parameters
    ({name: dim}, `sharded_names`) and the ("model", "space", "data") mesh
    of the ranks (parallel/mesh.py::state_mesh), for `as_global`."""
    names: Dict[str, int]
    mesh: object


def sharded_names(net: nn.Module, tp: int, min_width: int = 256
                  ) -> Dict[str, int]:
    """{parameter name: its sharded dim} under sdm_tpu's
    tp_param_shardings rule: a layer's weight whose output-channel dim is
    >= min_width and divisible by tp."""
    out = {}
    for name, layer in net.named_modules():
        dim = getattr(layer, "tp_out_dim", None)
        if dim is None:
            continue
        width = layer.weight.shape[dim]
        if layer.weight.ndim >= 2 and width >= min_width and width % tp == 0:
            out[f"{name}.weight" if name else "weight"] = dim
    return out


def shard_model(net: nn.Module, group, min_width: int = 256
                ) -> Dict[str, int]:
    """Cut each picked weight of `net` (whole, the same on every rank) to
    this rank's shard in place and make its layer column-parallel. Returns
    `sharded_names`. Build the optimizer and the EMA after this."""
    size, rank = _comm.size(group), _comm.rank(group)
    names = sharded_names(net, size, min_width)
    for name, layer in net.named_modules():
        dim = names.get(f"{name}.weight" if name else "weight")
        if dim is None:
            continue
        n = layer.weight.shape[dim] // size
        layer.weight = nn.Parameter(
            layer.weight.detach().narrow(dim, rank * n, n).clone())
        layer.tp = ColumnShard(group, rank, size, dim)
    return names


def column(layer, x: torch.Tensor, fn, dim: int) -> torch.Tensor:
    """A column-parallel layer's output before its bias: fn(x, weight
    shard) on this rank's channels, gathered on `dim` (1, a conv's
    channels; -1, a linear's features)."""
    shard = layer.tp
    x = _comm.CopyToGroup.apply(x, shard.group)
    return _comm.GatherFromGroup.apply(fn(x, layer.weight), shard.group,
                                       dim)


def full_weight(layer) -> torch.Tensor:
    """The layer's whole weight: gathered when it is a shard (the backward
    keeps this rank's slice of the whole gradient)."""
    if getattr(layer, "tp", None) is None:
        return layer.weight
    return _comm.GatherFromGroup.apply(layer.weight, layer.tp.group,
                                       layer.tp.dim)


def shard_tree(tree: Dict[str, torch.Tensor], names: Dict[str, int],
               rank: int, size: int) -> Dict[str, torch.Tensor]:
    """`tree` ({parameter name: whole tensor}) with the sharded entries cut
    to rank's shard."""
    out = {}
    for k, v in tree.items():
        dim = names.get(k)
        if dim is not None and v.ndim > dim:
            n = v.shape[dim] // size
            v = v.narrow(dim, rank * n, n).clone()
        out[k] = v
    return out


def shard_optimizer_entry(entry: dict, param_names, names: Dict[str, int],
                          rank: int, size: int) -> dict:
    """A checkpoint's "optimizer" entry (io/checkpoint.py's format, state
    keyed by the index in `param_names`) with each sharded parameter's
    moments cut to rank's shard."""
    state = {}
    for k, st in entry["state"].items():
        name = param_names[int(k)]
        state[k] = {key: (shard_tree({name: v}, names, rank, size)[name]
                          if torch.is_tensor(v) and v.ndim > 0 else v)
                    for key, v in st.items()}
    return dict(entry, state=state)


def gather_whole(tree: Dict[str, torch.Tensor], names: Dict[str, int],
                 group) -> Dict[str, torch.Tensor]:
    """`tree` ({name: tensor}) with every entry whole: FSDP2's DTensors
    gathered over their data ranks, then the tensor-parallel shards
    (`names`) over the model `group`, one all-gather each. A collective:
    every rank calls it with the same names."""
    out = {k: v.detach() for k, v in tree.items()}
    fsdp = [k for k, v in out.items() if hasattr(v, "full_tensor")]
    if fsdp:
        mesh = out[fsdp[0]].device_mesh
        whole = _comm.gather_chunks(
            [out[k].to_local() for k in fsdp],
            [out[k].placements[-1].dim for k in fsdp],
            [out[k].shape[out[k].placements[-1].dim] for k in fsdp],
            mesh.get_group(mesh.ndim - 1))
        out.update(zip(fsdp, whole))
    sharded = [k for k in out if names.get(k) is not None
               and out[k].ndim > names[k]]
    if sharded and group is not None:
        n = _comm.size(group)
        whole = _comm.gather_chunks(
            [out[k] for k in sharded], [names[k] for k in sharded],
            [out[k].shape[names[k]] * n for k in sharded], group)
        out.update(zip(sharded, whole))
    return out


def checkpoint_dict(net: nn.Module, optimizer, lr: float,
                    ema: Optional[Dict[str, torch.Tensor]],
                    names: Dict[str, int], group) -> Optional[dict]:
    """io/checkpoint.py's diffusion_checkpoint_dict of a tensor-parallel
    or FSDP2 run (`names` {} and `group` None without TP): parameters,
    Adam moments (in the reference's order) and the EMA gathered whole, on
    the CPU of global rank 0. A collective: every rank calls it; the
    others get None."""
    import torch.distributed as dist
    from sdm_tpu_torch.io.checkpoint import optimizer_entry
    main = dist.get_rank() == 0
    model = gather_whole(net.state_dict(), names, group)
    param_names = [n for n, _ in net.named_parameters()]
    sd = optimizer.state_dict()
    state = {idx: sd["state"][idx] for idx in range(len(param_names))
             if idx in sd["state"]}
    for key in ("exp_avg", "exp_avg_sq"):
        whole = gather_whole({param_names[i]: st[key]
                              for i, st in state.items()}, names, group)
        for i in state:
            state[i] = dict(state[i], **{key: whole[param_names[i]]})
    ema_full = None if ema is None else gather_whole(ema, names, group)
    if not main:
        return None
    cpu = {k: v.to("cpu", torch.float32, copy=True) for k, v in model.items()}
    out = {"model": cpu}
    if ema_full is not None:
        out["ema"] = {k: v.to("cpu", torch.float32, copy=True)
                      for k, v in ema_full.items()}
    out["optimizer"] = optimizer_entry(
        state, sd["param_groups"], [cpu[n] for n in param_names], lr, "cpu")
    return out


def grad_norm_fn(net: nn.Module, names: Dict[str, int], group,
                 data_group=None):
    """The global gradient norm of a tensor-parallel model: the sharded
    parameters' squares summed over the model group, the replicated ones'
    counted once (for "grad_clip_norm"). Under FSDP2 (`data_group`, the
    group its shards split over) each gradient's local squares are summed
    over that group first."""
    sharded = {id(p) for n, p in net.named_parameters() if n in names}

    def norm(params) -> torch.Tensor:
        sums = torch.zeros(2, device=params[0].device)
        for p in params:
            g = p.grad.to_local() if hasattr(p.grad, "to_local") else p.grad
            sums[int(id(p) not in sharded)] += g.float().square().sum()
        if data_group is not None:
            sums = _comm.all_reduce(sums, data_group)
        return torch.sqrt(_comm.all_reduce(sums[:1], group)[0] + sums[1])
    return norm


def as_global(t: torch.Tensor, dim: Optional[int], states) -> torch.Tensor:
    """A state entry as the tensor it is a piece of: `t` itself where it
    is whole (dim None), or FSDP2's DTensor of the whole local shard;
    else a DTensor of the whole tensor on `states` (parallel/mesh.py::
    state_mesh) holding this rank's `t` (for a native checkpoint)."""
    if dim is None:
        return t
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if isinstance(t, DTensor):      # FSDP2's shard of this rank's shard
        local, data = t.to_local(), t.placements[-1]
    else:
        local, data = t, Replicate()
    shape = list(t.shape)
    shape[dim] *= states.size(0)                # the "model" dim
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    return DTensor.from_local(local, states, [Shard(dim), Replicate(), data],
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))
