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

With model parallelism (sdm_tpu fsdp.py:15-18, 76-95) FSDP2 shards over
the data ranks only (parallel/mesh.py::fsdp_mesh): under "sp" the space
ranks hold replicas and average their gradients (FSDP2's hybrid mode over
("space", "data")), and under "tp" it shards each rank's tensor-parallel
shard (parallel/tp.py), on the largest dim that TP left whole and the data
ranks divide (sdm_tpu's `extend_spec`; dim 0 where none does).

Checkpoints gather the whole state (parallel/tp.py::checkpoint_dict, a
collective every rank runs) and rank 0 writes it in the unsharded run's
format; resume loads a whole state into the sharded model
(`load_optimizer`).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import torch
from torch import nn


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


def extend_dim(shape, taken: int, n: int) -> int:
    """sdm_tpu's extend_spec for a tensor-parallel shard: the largest dim
    other than `taken` that n divides, else 0 (FSDP2 pads dim 0 only)."""
    dims = [i for i, d in enumerate(shape) if i != taken and d % n == 0]
    return max(dims, key=lambda i: shape[i]) if dims else 0


def shard_model(net: nn.Module, mesh, *, min_size: int = 2 ** 15,
                tp_dims: Optional[Dict[str, int]] = None) -> nn.Module:
    """`net` sharded in place over `mesh` (1-D, or ("space", "data")):
    fully_shard on each unit, then on the root. `tp_dims` ({name: dim} of
    the tensor-parallel shards) moves those shards' FSDP2 dim off TP's.
    Build the optimizer and the EMA after this, over the sharded
    parameters."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard
    n = mesh.size(mesh.ndim - 1)
    taken = {id(p): (tp_dims or {}).get(name)
             for name, p in net.named_parameters()}

    def placement(p):
        dim = taken.get(id(p))
        return Shard(0 if dim is None else extend_dim(p.shape, dim, n))
    for block in units(net, min_size):
        fully_shard(block, mesh=mesh, shard_placement_fn=placement)
    fully_shard(net, mesh=mesh, shard_placement_fn=placement)
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
