"""Data-parallel sizing, the device mesh and row sharding (port of
sdm_tpu/parallel/mesh.py).

sdm_tpu shards a batch's rows over a 1-D "data" mesh and lets XLA insert
the gradient all-reduce. Here training runs one process per device under
DistributedDataParallel (train/loop.py), the mesh is a 1-D
`init_device_mesh` over the group (FSDP2 shards over it), and a rank
takes its contiguous block of each global batch's rows (`shard_batch`),
as P("data") places them. Sampling (the engine and the generators) stays
in one process: `Replicas` holds one copy of a U-Net per device and
splits each call's rows over them. Under tensor parallelism or spatial
partitioning the ranks form sdm_tpu's [dp, tp, sp] mesh, with a group for
each axis (`make_model_mesh`); FSDP2 composed with them shards over
`fsdp_mesh`, and a native checkpoint places their shards on
`state_mesh`.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import List, Optional, Sequence

import torch


def data_parallel_size(batch_size: int, num_devices: Optional[int],
                       available: int) -> int:
    """sdm_tpu's auto_data_mesh rule: with num_devices None the largest
    count of the `available` devices that divides batch_size, else exactly
    num_devices. Raises ValueError when the batch does not divide, and
    when num_devices exceeds `available` (sdm_tpu slices its device list
    instead, which silently runs on fewer)."""
    if num_devices is None:
        num_devices = max(d for d in range(1, max(available, 1) + 1)
                          if batch_size % d == 0)
    if num_devices < 1:
        raise ValueError(f"num_devices must be >= 1, got {num_devices}")
    if num_devices > available:
        raise ValueError(f"{num_devices} devices asked for, {available} "
                         "visible")
    if batch_size % num_devices != 0:
        raise ValueError(f"batch size {batch_size} must be divisible by "
                         f"{num_devices} devices")
    return num_devices


def device_count(device, batch_size: int,
                 num_devices: Optional[int]) -> int:
    """How many devices a data-parallel run on `device` takes for a batch
    of batch_size rows: on CUDA `data_parallel_size` over the cards this
    process sees; on the CPU num_devices (default 1) processes or
    replicas, any count that divides the batch."""
    if torch.device(device).type == "cpu":
        n = num_devices or 1
        return data_parallel_size(batch_size, n, n)
    return data_parallel_size(batch_size, num_devices,
                              torch.cuda.device_count())


def make_mesh(device_type: str):
    """The 1-D "data" mesh over every rank of the process group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=("data",))


@dataclasses.dataclass(frozen=True)
class ModelMesh:
    """The ("data", "model", "space") layout of the process group (sdm_tpu
    train/loop.py:447-466): global rank r = d*tp*sp + m*sp + s holds batch
    row block d, weight shard m and H slab s, as sdm_tpu's device r does.
    `reduce_group` joins the ranks of one model index (data x space): the
    gradients average over it (parallel/sp.py explains the factor)."""
    dp: int
    tp: int
    sp: int
    data: int
    model: int
    space: int
    mesh: object
    model_group: object
    space_group: object
    reduce_group: object


def make_model_mesh(device_type: str, tp: int, sp: int) -> ModelMesh:
    """The [dp, tp, sp] mesh over every rank of the group (dp = world /
    (tp * sp)) and its sub-groups. A collective: every rank calls it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    world, r = dist.get_world_size(), dist.get_rank()
    if world % (tp * sp):
        raise ValueError(f"tp={tp} x sp={sp} must divide the device count "
                         f"{world}")
    dp = world // (tp * sp)
    mesh = init_device_mesh(device_type, (dp, tp, sp),
                            mesh_dim_names=("data", "model", "space"))
    if tp == 1:
        reduce_group = None                      # the whole world
    elif sp == 1:
        reduce_group = mesh["data"].get_group()
    else:
        reduce_group = None
        for m in range(tp):                      # every rank makes each
            ranks = [d * tp * sp + m * sp + s for d in range(dp)
                     for s in range(sp)]
            g = dist.new_group(ranks)
            if r in ranks:
                reduce_group = g
    return ModelMesh(dp=dp, tp=tp, sp=sp, data=r // (tp * sp),
                     model=(r // sp) % tp, space=r % sp, mesh=mesh,
                     model_group=mesh["model"].get_group(),
                     space_group=mesh["space"].get_group(),
                     reduce_group=reduce_group)


def fsdp_mesh(mesh: ModelMesh):
    """FSDP2's mesh within `mesh`: this rank's data ranks ("data"), or
    under sp its ("space", "data") ranks (those of its model index):
    FSDP2's hybrid mode, replicas over space, shards over data, so the
    space ranks average their gradients as DDP's reduce group does. A
    collective: every rank builds every model index's mesh, in one order
    (each its own root mesh: older torch refuses this slice of the
    [dp, tp, sp] mesh)."""
    if mesh.sp == 1:
        return mesh.mesh["data"]
    from torch.distributed.device_mesh import DeviceMesh
    ranks = torch.arange(mesh.dp * mesh.tp * mesh.sp).reshape(
        mesh.dp, mesh.tp, mesh.sp)
    meshes = [DeviceMesh(mesh.mesh.device_type, ranks[:, m, :].T.contiguous(),
                         mesh_dim_names=("space", "data"))
              for m in range(mesh.tp)]
    return meshes[mesh.model]


def state_mesh(mesh: ModelMesh):
    """The ranks of `mesh` as a ("model", "space", "data") DeviceMesh, on
    which a tensor-parallel shard, and FSDP2's shard of it, is a DTensor of
    its whole tensor for a native checkpoint (parallel/tp.py::as_global):
    in this order DTensor nests the data shard inside the model shard, as
    FSDP2 cuts it. A collective: every rank calls it."""
    from torch.distributed.device_mesh import DeviceMesh
    ranks = torch.arange(mesh.dp * mesh.tp * mesh.sp).reshape(
        mesh.dp, mesh.tp, mesh.sp).permute(1, 2, 0)
    return DeviceMesh(mesh.mesh.device_type, ranks,
                      mesh_dim_names=("model", "space", "data"))


def shard_rows(n: int, rank: int, world: int) -> slice:
    """Rank `rank`'s contiguous block of n rows (n divisible by world)."""
    if n % world:
        raise ValueError(f"{n} rows do not split over {world} ranks")
    per = n // world
    return slice(rank * per, (rank + 1) * per)


def shard_batch(batch: dict, rank: int, world: int, axis: int = 0) -> dict:
    """This rank's rows of a global batch {key: array or tensor}, along
    `axis` (1 for a grad-accumulation stack (A, N/A, ...), whose
    micro-batches split over the ranks as P(None, "data") does)."""
    out = {}
    for k, v in batch.items():
        rows = shard_rows(v.shape[axis], rank, world)
        out[k] = v[(slice(None),) * axis + (rows,)]
    return out


def batch_positions(batch_size: int, grad_accum: int, rank: int,
                    world: int) -> List[int]:
    """The positions in a global batch of batch_size rows that rank `rank`
    trains on: its block of each of the grad_accum micro-batches, in
    order, so its rows reshape to its own (A, N/A/world) stack."""
    micro = batch_size // grad_accum
    rows = shard_rows(micro, rank, world)
    return [a * micro + i for a in range(grad_accum)
            for i in range(rows.start, rows.stop)]


def sampling_devices(device: torch.device, num_devices: Optional[int],
                     batch_size: int) -> List[torch.device]:
    """The devices a sampler's batch of batch_size rows splits over
    (`device_count`): the CUDA cards 0..n-1, or n replicas on the CPU."""
    n = device_count(device, batch_size, num_devices)
    if device.type == "cpu" or n == 1:
        return [device] * n
    if (device.index or 0) != 0:
        raise ValueError(f"data-parallel sampling starts at cuda:0, not "
                         f"{device}")
    return [torch.device("cuda", i) for i in range(n)]


class Replicas:
    """One copy of `net` per device of `devices` (the first is `net`
    itself). A call splits x's rows evenly over the copies, moves each
    block to its copy's device, launches every copy's forward from this
    thread (so the devices run together) and gathers the outputs on the
    first device. t and labels are split with x when they carry one entry
    per row, else copied whole. Carries `net`'s v tag."""

    def __init__(self, net: torch.nn.Module, devices: Sequence):
        self.devices = [torch.device(d) for d in devices]
        self.nets = [net] + [copy.deepcopy(net).to(d)
                             for d in self.devices[1:]]
        if hasattr(net, "model_output"):
            self.model_output = net.model_output

    def __call__(self, x, t=None, labels=None):
        k = len(self.nets)
        if k == 1:
            return self.nets[0](x, t, labels)
        n = x.shape[0]

        def part(v, i, dev, per_row):
            if v is None:
                return None
            if per_row:
                v = v[shard_rows(n, i, k)]
            return v.to(dev, non_blocking=True)

        t_rows = t is not None and t.ndim >= 1 and t.shape[0] == n and n > 1
        l_rows = labels is not None and labels.ndim >= 2
        outs = [net(part(x, i, dev, True), part(t, i, dev, t_rows),
                    part(labels, i, dev, l_rows))
                for i, (net, dev) in enumerate(zip(self.nets, self.devices))]
        home = self.devices[0]
        return torch.cat([o.to(home, non_blocking=True) for o in outs])
