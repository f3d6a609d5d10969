"""Spatial partitioning (SP): every image activation split along H over a
"space" group (port of sdm_tpu/parallel/sp.py, config "sp" and the
generators' --sp).

sdm_tpu annotates only the input sharding and lets GSPMD insert the halo
exchanges, the cross-slab GroupNorm reductions and the key/value gathers.
Here each rank holds rows [s*h, (s+1)*h) of every activation (h = H/sp at
each level) and the layers do those steps by hand while a `spatial(shard)`
context is active on the calling thread (models/layers.py asks
`active()`; outside it, and on every other thread, each layer runs its
one-device path):

  - convs (`conv_halo`, `halo`): a 3x3 stride-1 conv takes one row from
    each neighbour, the 3x3 stride-2 downsample only the row above (the
    slab height is even; the padding stays (1, 1)), the k=4 s=2 p=1
    transposed conv one input row each side with its H padding raised to
    3, which crops the output to [2a, 2b); 1x1 shortcuts none. Edge ranks
    get zero rows, as padding=1 gives. The exchange is an autograd
    Function: its backward sends the halos' gradients back and adds them.
  - GroupNorm (`group_norm`): sdm_tpu's two passes in fp32 (the mean from
    an all-reduced sum, then the variance from an all-reduced centered sum
    of squares).
  - attention (`attention`): the queries are this slab's tokens; keys and
    values are all-gathered over the group (their gradients reduce-scatter
    back, since each rank's queries use every key). The key-axis softmax
    stays local; the query-axis softmax (the parity quirk) normalizes each
    key's column over all queries, so its max (detached) and its sum
    reduce over the group. Each rank does S/sp x S of the score work.

The kernels run on whole images only, so under sp > 1 the trainers and the
generators build their U-Nets with use_kernels=False, as sdm_tpu forces
use_pallas=False (a layer with kernels on raises inside the context).

Loss and gradients. Each rank's loss is the mean over its slab (sq summed
locally over the global element count, times sp); the gradients average
over the data x space ranks of one model index (DDP over
ModelMesh.reduce_group), which sums them over the space group and
averages them over the data group, as the one-device gradient needs.

sdm_tpu checks only the input height; GSPMD pads deeper levels whose
height does not divide. Here every level's height must divide by sp
(`check_levels` raises a ValueError naming the level), a known divergence.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Tuple

import torch

from sdm_tpu_torch.parallel import _comm
from sdm_tpu_torch.parallel.mesh import shard_rows


@dataclasses.dataclass(frozen=True)
class SpaceShard:
    """This rank's slab: index `rank` of `size` in `group`."""
    group: object
    rank: int
    size: int

    def rows(self, h: int) -> slice:
        """This rank's block of h rows (ValueError unless h divides)."""
        validate_spatial_divisibility((1, h, 1, 1), self.size)
        per = h // self.size
        return slice(self.rank * per, (self.rank + 1) * per)


# Per thread: another thread of the process (the checkpoint worker's
# preview) runs its layers whole while a step is split.
_local = threading.local()


def active() -> Optional[SpaceShard]:
    """The shard of this thread's running `spatial` context, or None."""
    return getattr(_local, "shard", None)


@contextlib.contextmanager
def spatial(shard: Optional[SpaceShard]):
    """Layers run on this thread split along H over `shard` inside (None:
    a no-op). A remat replay in the backward, which may run on autograd's
    own thread, enters it again there (models/layers.py::remat_call)."""
    if shard is None:
        yield
        return
    prev, _local.shard = active(), shard
    try:
        yield
    finally:
        _local.shard = prev


# ---------------------------------------------------- sdm_tpu's rules

def spatial_batch_spec(ndim: int, *, leading_stack: bool = False,
                       data_axis: str = "data",
                       space_axis: str = "space") -> tuple:
    """The axes a batch array splits over, as sdm_tpu's PartitionSpec:
    image tensors (N, H, W, C) batch over data and H over space; (N, D)
    tensors batch only; a grad-accumulation stack keeps axis 0 whole."""
    body = ndim - (1 if leading_stack else 0)
    spec = [data_axis, space_axis] if body >= 4 else (
        [data_axis] if body >= 1 else [])
    if leading_stack:
        spec = [None] + spec
    return tuple(spec)


def validate_spatial_divisibility(shape, sp: int, *, name: str = "image",
                                  leading_stack: bool = False) -> None:
    """An image array's H must divide by sp (sdm_tpu's message)."""
    ndim = len(shape) - (1 if leading_stack else 0)
    if ndim < 4:
        return
    h = shape[-3]
    if h % sp:
        raise ValueError(
            f'"{name}" height {h} must be divisible by sp={sp}')


def check_levels(h: int, num_layers: int, sp: int) -> None:
    """Every U-Net level's height (h / 2**i, i = 0..num_layers) must divide
    by sp. sdm_tpu checks the input only (GSPMD pads the rest)."""
    for i in range(num_layers + 1):
        if h % (2 ** i * sp):
            raise ValueError(
                f"U-Net level {i} has height {h / 2 ** i:g}, which must be "
                f"divisible by sp={sp} (every level's slab is split along H)")


def auto_dp_sp(batch_size: int, num_devices: Optional[int], sp: int,
               available: int) -> Tuple[int, int]:
    """(dp, sp) for sampling: sdm_tpu's auto_dp_sp_mesh rule and messages.
    With num_devices, dp = num_devices / sp; otherwise the largest dp
    dividing batch_size with dp * sp of the `available` devices."""
    if sp < 1:
        raise ValueError(f"sp must be >= 1, got {sp}")
    if num_devices is not None:
        if num_devices % sp:
            raise ValueError(
                f"--num-devices {num_devices} must be divisible by sp={sp}")
        dp = num_devices // sp
    else:
        if available < sp:
            raise ValueError(f"sp={sp} needs {sp} devices, have {available}")
        dp = max(d for d in range(1, available // sp + 1)
                 if batch_size % d == 0)
    if batch_size % dp:
        raise ValueError(
            f"batch size {batch_size} must be divisible by the data-axis "
            f"size {dp}")
    if dp * sp > available:
        raise ValueError(f"need {dp * sp} devices, have {available}")
    return dp, sp


def slab(x: torch.Tensor, shard: SpaceShard, axis: int = 1) -> torch.Tensor:
    """This rank's H slab of an NHWC array (H on `axis`)."""
    rows = shard.rows(x.shape[axis])
    return x.narrow(axis, rows.start, rows.stop - rows.start)


# ------------------------------------------------------------ the layers

def conv_halo(kernel: int, stride: int, padding: int,
              transposed: bool = False) -> Tuple[int, int, int]:
    """(rows from above, rows from below, H padding) of a conv over a
    slab: a conv's output block [a/s, b/s) reads input rows [a - p,
    b - s - p + k); a transposed conv's output [s*a, s*b) reads input rows
    [a - above, b + below), placed by padding s*above + p."""
    if transposed:
        above = (kernel - 1 - padding) // stride
        below = (stride - 1 + padding) // stride
        return above, below, stride * above + padding
    return padding, kernel - stride - padding, 0


class _Halo(torch.autograd.Function):
    """x (N, C, h, W) -> (N, C, above + h + below, W) with the neighbours'
    border rows (zeros past the edges); the backward returns the halos'
    gradients to their owners."""

    @staticmethod
    def forward(ctx, x, shard, above, below):
        ctx.shard, ctx.above, ctx.below = shard, above, below
        n, c, h, w = x.shape
        top, bottom = _comm.exchange(
            shard.group, x[:, :, :below] if below else None,
            x[:, :, h - above:] if above else None,
            (n, c, above, w) if above else None,
            (n, c, below, w) if below else None, x)
        parts = [top if top is not None else x.new_zeros((n, c, above, w)),
                 x,
                 bottom if bottom is not None
                 else x.new_zeros((n, c, below, w))]
        out = torch.cat(parts, dim=2)
        if x.is_contiguous(memory_format=torch.channels_last):
            out = out.contiguous(memory_format=torch.channels_last)
        return out

    @staticmethod
    def backward(ctx, g):
        above, below = ctx.above, ctx.below
        n, c, hh, w = g.shape
        h = hh - above - below
        gx = g[:, :, above:above + h].clone()
        from_prev, from_next = _comm.exchange(
            ctx.shard.group, g[:, :, :above] if above else None,
            g[:, :, above + h:] if below else None,
            (n, c, below, w) if below else None,
            (n, c, above, w) if above else None, g)
        if from_prev is not None:
            gx[:, :, :below] += from_prev
        if from_next is not None:
            gx[:, :, h - above:] += from_next
        return gx, None, None, None


def halo(x: torch.Tensor, shard: SpaceShard, above: int,
         below: int) -> torch.Tensor:
    """An NCHW slab with `above` rows of the rank before and `below` of
    the rank after."""
    if above == 0 and below == 0:
        return x
    return _Halo.apply(x, shard, above, below)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float, shard: SpaceShard
               ) -> torch.Tensor:
    """ops/norms.py's group_norm of an NHWC slab, its statistics over the
    whole image: fp32, two passes, each sum all-reduced over the group."""
    orig_dtype = x.dtype
    n, c = x.shape[0], x.shape[-1]
    if c % num_groups != 0:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    xg = x.to(torch.float32).reshape(n, -1, num_groups, c // num_groups)
    count = xg.shape[1] * xg.shape[3] * shard.size
    mean = _comm.AllReduceSum.apply(xg.sum(dim=(1, 3), keepdim=True),
                                    shard.group) / count
    d = xg - mean
    var = _comm.AllReduceSum.apply(d.square().sum(dim=(1, 3), keepdim=True),
                                   shard.group) / count
    xn = (d * torch.reciprocal(torch.sqrt(var + eps))).reshape(x.shape)
    out = xn * scale.to(torch.float32) + bias.to(torch.float32)
    return out.to(orig_dtype)


def attention(q, k, v, scale: float, softmax_axis: str,
              shard: SpaceShard) -> torch.Tensor:
    """kernels/attention.py's attention_reference for this slab's queries
    (N, S/sp, heads, D) against every key and value of the image."""
    kf = _comm.GatherSum.apply(k.contiguous(), shard.group, 1)
    vf = _comm.GatherSum.apply(v.contiguous(), shard.group, 1)
    qh, kh, vh = (t.permute(0, 2, 1, 3).to(torch.float32)
                  for t in (q, kf, vf))
    scores = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    if softmax_axis == "k":
        p = torch.softmax(scores, dim=-1)
    else:
        m = _comm.all_reduce(scores.detach().amax(dim=-2, keepdim=True),
                             shard.group, op=torch.distributed.ReduceOp.MAX)
        e = torch.exp(scores - m)
        p = e / _comm.AllReduceSum.apply(e.sum(dim=-2, keepdim=True),
                                         shard.group)
    p = p.to(v.dtype).to(torch.float32)
    out = torch.matmul(p, vh).to(v.dtype)
    return out.permute(0, 2, 1, 3)


class SpatialModel:
    """A U-Net for a sampler that runs whole-batch math the same on every
    rank (the generators under --sp): each call takes this rank's rows
    (data rank of `mesh`, a parallel/mesh.py ModelMesh with tp = 1) and H
    slab of x, runs the U-Net on them inside `spatial`, and all-gathers
    every rank's output back into the whole (N, H, W, C). t and labels are
    cut with x when they carry one entry per row. So every rank draws the
    one-device run's noise and ends with its images. Carries `net`'s v
    tag."""

    def __init__(self, net, mesh):
        self.net, self.mesh = net, mesh
        self.shard = SpaceShard(mesh.space_group, mesh.space, mesh.sp)
        if hasattr(net, "model_output"):
            self.model_output = net.model_output

    def __call__(self, x, t=None, labels=None):
        n, dp, sp = x.shape[0], self.mesh.dp, self.mesh.sp
        rows = shard_rows(n, self.mesh.data, dp)
        if t is not None and t.ndim >= 1 and t.shape[0] == n and n > 1:
            t = t[rows]
        if labels is not None and labels.ndim >= 2:
            labels = labels[rows]
        with spatial(self.shard):
            out = self.net(slab(x[rows], self.shard), t, labels)
        out = out.contiguous()
        parts = [torch.empty_like(out) for _ in range(dp * sp)]
        _comm.record("all-gather", _comm.nbytes(out) * dp * sp)
        torch.distributed.all_gather(parts, out)
        return torch.cat([torch.cat(parts[d * sp:(d + 1) * sp], dim=1)
                          for d in range(dp)])
