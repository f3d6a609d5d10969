"""Fully-sharded data parallelism over the "data" mesh (port of
sdm_tpu/parallel/fsdp.py, config "fsdp").

sdm_tpu annotates each large state leaf with a sharding over the data axis
and lets XLA turn the gradient all-reduce into a reduce-scatter. Here it
is FSDP2 (`torch.distributed.fsdp.fully_shard`): every parameter, and so
its Adam moments and EMA, lives as a DTensor sharded on dim 0 over the
ranks; each unit all-gathers its parameters for its forward and backward
and reduce-scatters its gradients. The numerics are the replicated run's.

Units: each block of the U-Net (a child module, a ModuleList's entries
taken one by one) of at least `min_size` parameters (config
"fsdp_min_size", default 2**15) is a unit of its own, so its parameters
are gathered only while it runs; the smaller blocks join the root unit,
gathered for the whole forward. Every parameter is sharded either way
(sdm_tpu keeps leaves under min_size replicated; the key sets the
granularity of the gathers here). A unit is a whole block, never a single
layer: an attention block hands its projections' weights to the `linear`
kernel from its own forward, which must see them gathered.

Checkpoints gather the whole state (`checkpoint_dict`, a collective every
rank runs) and rank 0 writes it in the unsharded run's format; resume
loads a whole state into the sharded model (`load_optimizer`).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import torch
from torch import nn

from sdm_tpu_torch.io.checkpoint import optimizer_entry


def units(net: nn.Module, min_size: int) -> List[nn.Module]:
    """The blocks of `net` that get a unit of their own."""
    blocks: List[nn.Module] = []
    for child in net.children():
        if isinstance(child, (nn.ModuleList, nn.Sequential)):
            blocks.extend(child)
        else:
            blocks.append(child)
    return [b for b in blocks
            if sum(p.numel() for p in b.parameters()) >= min_size]


def shard_model(net: nn.Module, mesh, *, min_size: int = 2 ** 15
                ) -> nn.Module:
    """`net` sharded in place over `mesh`: fully_shard on each unit, then
    on the root. Build the optimizer and the EMA after this, over the
    sharded parameters."""
    from torch.distributed.fsdp import fully_shard
    for block in units(net, min_size):
        fully_shard(block, mesh=mesh)
    fully_shard(net, mesh=mesh)
    return net


def _tensors(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, torch.optim.Optimizer):
        for st in tree.state.values():
            yield from _tensors(st)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif torch.is_tensor(tree):
        yield tree


def state_bytes_per_device(*trees) -> int:
    """The bytes this rank (one device) holds of `trees`: modules (their
    parameters and buffers), optimizers (their state) and dicts or lists
    of tensors; a sharded tensor counts its local shard."""
    seen, total = set(), 0
    for tree in trees:
        for t in _tensors(tree):
            if id(t) not in seen:
                seen.add(id(t))
                local = t.to_local() if hasattr(t, "to_local") else t
                total += local.numel() * local.element_size()
    return total


def _full_options():
    from torch.distributed.checkpoint.state_dict import StateDictOptions
    return StateDictOptions(full_state_dict=True, cpu_offload=True)


def checkpoint_dict(net: nn.Module, optimizer, lr: float,
                    ema: Optional[Dict[str, torch.Tensor]] = None
                    ) -> Optional[dict]:
    """io/checkpoint.py's diffusion_checkpoint_dict of a sharded run: the
    whole model, Adam state and EMA gathered to the CPU of rank 0, in the
    unsharded run's format and keys. A collective: every rank calls it;
    ranks other than 0 get None."""
    import torch.distributed as dist
    from torch.distributed.checkpoint.state_dict import (
        get_model_state_dict, get_optimizer_state_dict)
    from sdm_tpu_torch.parallel.multihost import localize
    model_sd = get_model_state_dict(net, options=_full_options())
    optim_sd = get_optimizer_state_dict(net, optimizer,
                                        options=_full_options())
    ema_full = localize(ema) if ema is not None else None
    if dist.get_rank() != 0:
        return None
    names = [n for n, _ in net.named_parameters()]
    index = {n: i for i, n in enumerate(names)}
    out = {"model": {k: v.to(torch.float32, copy=True)
                     for k, v in model_sd.items()}}
    if ema_full is not None:
        out["ema"] = {k: v.to(torch.float32, copy=True)
                      for k, v in ema_full.items()}
    groups = [dict(g, params=[index[n] for n in g["params"]])
              for g in optim_sd["param_groups"]]
    state = {index[n]: st for n, st in optim_sd["state"].items()}
    out["optimizer"] = optimizer_entry(
        state, groups, [model_sd[n] for n in names], lr, "cpu")
    return out


def load_optimizer(ckpt: dict, net: nn.Module, optimizer) -> int:
    """A checkpoint's whole Adam state (io/checkpoint.py's format) into the
    optimizer of the sharded `net`; returns the step count, as
    load_optimizer_from_checkpoint does. Every rank calls it."""
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions, set_optimizer_state_dict)
    sd = ckpt["optimizer"]
    names = [n for n, _ in net.named_parameters()]
    state = {names[int(k)]: v for k, v in sd["state"].items()}
    groups = [dict(g, params=[names[int(i)] for i in g["params"]])
              for g in sd["param_groups"]]
    set_optimizer_state_dict(
        net, optimizer, {"state": state, "param_groups": groups},
        options=StateDictOptions(full_state_dict=True))
    steps = [int(float(st["step"])) for st in sd["state"].values()]
    return steps[-1] if steps else 0
