"""Autograd-aware collectives of the model-parallel layers (parallel/tp.py,
parallel/sp.py) and the byte counts that parallel/analysis.py reads.

Every collective the port issues goes through `record`, which adds the
bytes that land on this rank to the counts of an active `counting()`
context, under sdm_tpu's kinds (parallel/analysis.py): an all-reduce its
whole buffer, an all-gather its gathered output, a reduce-scatter its
shard, a halo exchange (`exchange`, a "collective-permute") the rows it
receives. DistributedDataParallel's gradient buckets are counted by the
comm hook `data_parallel(..., count_bytes=True)` registers.

The Functions:
  CopyToGroup      identity forward, all-reduce of the gradient backward
                   (the input of a column-parallel layer);
  GatherFromGroup  all-gather along a dim forward, this rank's slice of
                   the gradient backward (the computation after it is
                   replicated on every member, so its gradient is whole on
                   each; torch.distributed.nn's all_gather would sum it);
  GatherSum        all-gather forward, reduce-scatter of the gradient
                   backward (SP's keys and values: every rank's queries use
                   every key, so the gradients do sum);
  AllReduceSum     all-reduce forward and backward (SP's GroupNorm and
                   query-axis softmax sums).

Tensors handed to a collective are dense: NCCL takes channels_last ones,
gloo only standard-contiguous ones.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch
import torch.distributed as dist

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "collective-permute",
         "all-to-all")

_counts: Optional[Dict[str, int]] = None


def record(kind: str, nbytes: int) -> None:
    if _counts is not None:
        _counts[kind] += int(nbytes)
        _counts["total"] += int(nbytes)


@contextlib.contextmanager
def counting():
    """Count the bytes of every collective issued inside; yields the
    {kind: bytes, "total": bytes} dict it fills."""
    global _counts
    prev, _counts = _counts, {k: 0 for k in KINDS + ("total",)}
    try:
        yield _counts
    finally:
        _counts = prev


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def size(group) -> int:
    return dist.get_world_size(group)


def rank(group) -> int:
    return dist.get_rank(group)


def dense(t: torch.Tensor, group) -> torch.Tensor:
    """`t` in a layout the group's backend takes."""
    if t.is_contiguous():
        return t
    if (t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last)
            and dist.get_backend(group) == "nccl"):
        return t
    return t.contiguous()


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """`t` all-reduced in place (a dense copy when it is not); returns it."""
    t = dense(t, group)
    record("all-reduce", nbytes(t))
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The members' `t` concatenated along `dim`, in group-rank order."""
    n = size(group)
    if n == 1:
        return t
    t = dense(t, group)
    parts = [torch.empty_like(t) for _ in range(n)]
    record("all-gather", nbytes(t) * n)
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def gather_chunks(chunks, dims, sizes, group):
    """Whole tensors from this rank's `chunks`, with one all-gather: chunk
    i is this rank's torch.chunk piece along dims[i] of a tensor of
    sizes[i] there (FSDP2's and DTensor's split, which may leave the last
    ranks short or empty; parallel/tp.py's even shards)."""
    n = size(group)
    if n == 1 or not chunks:
        return list(chunks)
    parts, plans = [], []
    for t, dim, full in zip(chunks, dims, sizes):
        per = -(-full // n)
        t = t.movedim(dim, 0)
        pad = t.new_zeros((per - t.shape[0],) + t.shape[1:])
        parts.append(torch.cat([t, pad]).reshape(-1))
        plans.append((dim, full, per, t.shape[1:]))
    flat = torch.cat(parts)
    bufs = [torch.empty_like(flat) for _ in range(n)]
    record("all-gather", nbytes(flat) * n)
    dist.all_gather(bufs, flat, group=group)
    out, off = [], 0
    for dim, full, per, rest in plans:
        count = per * math.prod(rest)
        pieces = [b[off:off + count].view((per,) + rest)[
            :max(0, min(per, full - i * per))] for i, b in enumerate(bufs)]
        out.append(torch.cat(pieces).movedim(0, dim).contiguous())
        off += count
    return out


def reduce_scatter(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block along `dim` of the members' `t` summed: NCCL's
    reduce-scatter; gloo has none, so there an all-reduce and the block."""
    n = size(group)
    if n == 1:
        return t
    per = t.shape[dim] // n
    if dist.get_backend(group) != "nccl":
        return all_reduce(t.clone(), group).narrow(dim, rank(group) * per,
                                                   per)
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((per,) + src.shape[1:])
    record("reduce-scatter", nbytes(out))
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim)


def exchange(group, to_prev: Optional[torch.Tensor],
             to_next: Optional[torch.Tensor], from_prev_shape,
             from_next_shape, like: torch.Tensor):
    """A halo exchange along the members' order: `to_prev` goes to rank - 1
    and `to_next` to rank + 1 (None: nothing that way); returns what rank
    - 1 and rank + 1 sent (tensors of the given shapes, None where there is
    no neighbour or no shape). Every member calls it with the same shapes."""
    r, n = rank(group), size(group)
    ops, got = [], [None, None]
    for i, (peer, send, shape) in enumerate(
            ((r - 1, to_prev, from_prev_shape),
             (r + 1, to_next, from_next_shape))):
        if not 0 <= peer < n:
            continue
        peer_global = dist.get_global_rank(group, peer)
        if send is not None:
            ops.append(dist.P2POp(dist.isend, dense(send, group).contiguous(),
                                  peer_global, group))
        if shape is not None:
            got[i] = like.new_empty(shape)
            record("collective-permute", nbytes(got[i]))
            ops.append(dist.P2POp(dist.irecv, got[i], peer_global, group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return got[0], got[1]


class CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if size(ctx.group) == 1:
            return g, None
        return all_reduce(g.clone(), ctx.group), None


class GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.width = group, dim, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        own = g.narrow(ctx.dim, rank(ctx.group) * ctx.width, ctx.width)
        return own.contiguous(), None, None


class GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


class AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


def data_parallel(net: torch.nn.Module, dev: torch.device, group=None, *,
                  count_bytes: bool = False):
    """`net` under DistributedDataParallel over `group` (None: the whole
    world). With `count_bytes` (parallel/analysis.py's readings), a comm
    hook counts each gradient bucket (`record`) and then runs torch's
    default all-reduce; the trainers keep DDP's own. The reference's dead
    weights get no gradient, hence find_unused_parameters."""
    ddp = torch.nn.parallel.DistributedDataParallel(
        net, device_ids=[dev.index] if dev.type == "cuda" else None,
        process_group=group, find_unused_parameters=True)
    if count_bytes:
        from torch.distributed.algorithms.ddp_comm_hooks import default_hooks

        def hook(process_group, bucket):
            record("all-reduce", nbytes(bucket.buffer()))
            return default_hooks.allreduce_hook(process_group, bucket)
        ddp.register_comm_hook(group, hook)
    return ddp
