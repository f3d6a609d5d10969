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
(`shard_tree`).
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


def _gather(v: torch.Tensor, dim: Optional[int], group) -> torch.Tensor:
    if dim is None:
        return v.detach()
    return _comm.all_gather(v.detach(), group, dim)


def checkpoint_dict(net: nn.Module, optimizer, lr: float,
                    ema: Optional[Dict[str, torch.Tensor]],
                    names: Dict[str, int], group) -> Optional[dict]:
    """io/checkpoint.py's diffusion_checkpoint_dict of a tensor-parallel
    run: parameters, Adam moments (in the reference's order) and the EMA
    gathered whole, on the CPU of global rank 0. A collective: every rank
    calls it; the others get None."""
    import torch.distributed as dist
    from sdm_tpu_torch.io.checkpoint import optimizer_entry
    main = dist.get_rank() == 0
    model = {k: _gather(v, names.get(k), group)
             for k, v in net.state_dict().items()}
    param_names = [n for n, _ in net.named_parameters()]
    sd = optimizer.state_dict()
    state = {}
    for idx, name in enumerate(param_names):
        st = sd["state"].get(idx)
        if st is not None:
            state[idx] = {k: (_gather(v, names.get(name), group)
                              if torch.is_tensor(v) and v.ndim > 0 else v)
                          for k, v in st.items()}
    ema_full = (None if ema is None else
                {k: _gather(v, names.get(k), group) for k, v in ema.items()})
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


def grad_norm_fn(net: nn.Module, names: Dict[str, int], group):
    """The global gradient norm of a tensor-parallel model: the sharded
    parameters' squares summed over the model group, the replicated ones'
    counted once (for "grad_clip_norm")."""
    sharded = {id(p) for n, p in net.named_parameters() if n in names}

    def norm(params) -> torch.Tensor:
        own = [p.grad.float().square().sum() for p in params
               if id(p) in sharded]
        rest = [p.grad.float().square().sum() for p in params
                if id(p) not in sharded]
        total = torch.stack(rest).sum() if rest else 0.0
        if own:
            total = total + _comm.all_reduce(torch.stack(own).sum(), group)
        return torch.sqrt(total)
    return norm
