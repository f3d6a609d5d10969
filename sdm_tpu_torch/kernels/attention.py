"""Self-attention over flattened H*W tokens, softmax over the query axis
("q", the reference's parity quirk) or the key axis ("k").

Port of sdm_tpu/kernels/attention.py::fused_attention (TPU kernel
`_attn_kernel`, sdm_tpu/kernels/attention.py:43-58, launched at :86). The
query-axis softmax has no library kernel: SDPA and flash attention
normalise over keys. The CUDA kernel (csrc/attention.cu) runs two passes on
both axes: softmax statistics over the whole reduced axis (column stats for
"q", row stats for "k"), then an apply pass that writes P V. bf16 at the
U-Net's shapes (`takes_mma`: S % 64 == 0, D % 128 == 0, D <= 1024, 16-byte
aligned rows) runs on the tensor cores through mma.sync: the stats on
`attn_stats_mma`, the apply on `stream_apply_mma` (D <= 512) or
`attn_apply_mma_wide`, split over output columns as `mma_plan` says; each
such call also counts in `fused_attention.mma_launches`. fp32, and bf16 at
other shapes, run on fp32 CUDA cores. It is bound by its 6*S*S*D operations
per head (scores twice, P V once).

`attention_reference` is the plain PyTorch version (sdm_tpu's
`_xla_attention`): fp32 scores, fp32 softmax, P cast to v's dtype, P V with
fp32 accumulation. `attention()` is the dispatcher the layers call: with
`use_kernels`, shapes the C entry point takes (`whole_s_ok`, its own
limits mirrored) go to `fused_attention` and longer grids to the streaming
kernel (kernels/streaming_attention.py); without it the plain version. The
TPU's `_AUTO_STREAMING_MIN_S` and `_whole_tile_ok` are not carried over.
When a gradient is wanted `fused_attention` runs as `FusedAttention`, whose
backward recomputes through `attention_reference` (sdm_tpu's VJP,
attention.py:193-199); streaming shapes differentiate through the streaming
kernels' own backward.
"""

from __future__ import annotations

import ctypes

import torch

from sdm_tpu_torch.kernels import _build
from sdm_tpu_torch.kernels._autograd import recompute_backward, wants_grad
from sdm_tpu_torch.kernels.streaming_attention import (
    MAX_SMEM, MMA_KEYS, MMA_MAX_D, MMA_QUERIES, apply_smem_bytes_mma,
    rows_aligned16, streaming_attention)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "sdm_attention_forward": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                   ctypes.c_float, _I, _I, _P]),
    "sdm_attention_fits": (_I, [_I, _I]),
    "sdm_attention_takes_mma": (_I, [_P, _P, _I, _I, _I]),
    "sdm_attention_mma_plan": (_I, [_I, _I, _I, _P]),
    "sdm_attention_wide_smem_bytes": (_I, [_I]),
}

# sdm_attention_forward's return when S is past the longest it takes (it
# then launches nothing).
_ERR_TOKENS = -1
# The longest S the tensor-core path takes whole (csrc/attention.cu
# WHOLE_S_MAX_MMA). Its kernels do not depend on S, but the route does: the
# whole-S backward is the plain recompute with an S x S softmax (sdm_tpu's
# VJP, attention.py:193), the streaming path has backward kernels of its
# own, so moving the limit would change the SR trainer's memory and
# kernels. 3200 is where the former WMMA apply's 32 x S P block stopped
# fitting in shared memory.
MAX_S_MMA = 3200
# attn_apply_mma_wide's K chunk and V stage pitch (XKC, XVLD).
WIDE_K_CHUNK = 128
# SMs of the H100, which mma_plan fills with about one wave of blocks.
SMS = 132


def apply_smem_bytes(s: int) -> int:
    """Shared memory of csrc/attention.cu's CUDA-core apply block at S = s
    (apply_smem_bytes): [32][S+1] fp32 scores and 4096 staging floats."""
    return (32 * (s + 1) + 4096) * 4


def wide_smem_bytes(d: int) -> int:
    """Dynamic shared memory of attn_apply_mma_wide at D = d
    (wide_smem_bytes): Q [64][d+8] bf16 resident, a K ring of three
    [32][136] bf16 chunks, a V ring of two [32][520] bf16 stages, the P tile
    [64][40] bf16 and two stages of 32 m and l floats."""
    return (MMA_QUERIES * (d + 8) * 2 + 3 * MMA_KEYS * (WIDE_K_CHUNK + 8) * 2
            + 2 * MMA_KEYS * (MMA_MAX_D + 8) * 2
            + MMA_QUERIES * (MMA_KEYS + 8) * 2 + 2 * 2 * MMA_KEYS * 4)


def admits_mma(dtype, s: int, d: int, ptrs, strides) -> bool:
    """csrc/attention.cu's mma_ok: bf16, S % 64 == 0, D % 128 == 0, the
    apply's shared memory within MAX_SMEM (stream_apply_mma to D = 512,
    attn_apply_mma_wide to D = 1024), 16-byte aligned rows. `ptrs` and
    `strides` ((sn, sh, ss) in elements) of q, k, v and out."""
    smem = apply_smem_bytes_mma(d) if d <= MMA_MAX_D else wide_smem_bytes(d)
    return (dtype == torch.bfloat16 and s % MMA_QUERIES == 0 and d % 128 == 0
            and smem <= MAX_SMEM and rows_aligned16(ptrs, strides))


def takes_mma(q, k, v) -> bool:
    """Whether these (N, S, H, D) inputs run on the tensor-core path. The
    output is a fresh contiguous (N, S, H, D) tensor: an aligned pointer and
    strides (S*H*D, D, H*D)."""
    n, s, h, d = q.shape
    return admits_mma(
        q.dtype, s, d, [t.data_ptr() for t in (q, k, v)] + [0],
        [(t.stride(0), t.stride(2), t.stride(1)) for t in (q, k, v)]
        + [(s * h * d, d, h * d)])


def fits(s: int, tensor_cores: bool) -> bool:
    """sdm_attention_fits: the tensor-core path takes S <= MAX_S_MMA, the
    CUDA-core path S whose 32 x S fp32 block fits in shared memory."""
    return s <= MAX_S_MMA if tensor_cores else apply_smem_bytes(s) <= MAX_SMEM


def whole_s_ok(q, k, v) -> bool:
    """Whether `fused_attention` takes these inputs: the mirror of
    sdm_attention_forward's admission (sdm_attention_fits in the C source).
    The dispatchers send everything else to the streaming kernel."""
    return fits(q.shape[1], takes_mma(q, k, v))


def mma_plan(bh: int, s: int, d: int):
    """csrc/attention.cu's mma_plan: (wide, split, d_per_block) of the
    tensor-core apply for bh = batch*heads rows of (S, D). About one wave
    of blocks (S/64 per row) on the 132 SMs, each split a multiple of 128
    columns and at most 512; wide: attn_apply_mma_wide (D > 512)."""
    chunks = d // 128
    blocks = bh * (s // MMA_QUERIES)
    split = max(-(-d // MMA_MAX_D), min(-(-SMS // blocks), chunks))
    d_per_block = -(-chunks // split) * 128
    return d > MMA_MAX_D, -(-d // d_per_block), d_per_block


def attention_reference(q, k, v, scale: float, softmax_axis: str = "q"):
    """Plain version. q, k, v (N, S, H, D) -> (N, S, H, D) in v's dtype."""
    qh, kh, vh = (t.permute(0, 2, 1, 3).to(torch.float32) for t in (q, k, v))
    scores = torch.matmul(qh, kh.transpose(-1, -2)) * scale   # (N, H, Sq, Sk)
    p = torch.softmax(scores, dim=-2 if softmax_axis == "q" else -1)
    p = p.to(v.dtype).to(torch.float32)
    out = torch.matmul(p, vh).to(v.dtype)
    return out.permute(0, 2, 1, 3)


def fused_attention(q, k, v, scale: float, softmax_axis: str = "q"):
    """q, k, v (N, S, H, D) with a unit D stride (views of a wider qkv
    buffer are fine); returns a contiguous (N, S, H, D) in q's dtype.

    CPU tensors run `attention_reference`; CUDA tensors launch
    csrc/attention.cu or raise. Differentiable (`FusedAttention`)."""
    if wants_grad(q, k, v):
        return FusedAttention.apply(q, k, v, scale, softmax_axis)
    return _forward(q, k, v, scale, softmax_axis)


fused_attention.launches = 0
fused_attention.mma_launches = 0


class FusedAttention(torch.autograd.Function):
    """The kernel forward; the backward differentiates `attention_reference`
    on the saved q, k, v."""

    @staticmethod
    def forward(ctx, q, k, v, scale, softmax_axis):
        ctx.save_for_backward(q, k, v)
        ctx.scale, ctx.softmax_axis = scale, softmax_axis
        return _forward(q, k, v, scale, softmax_axis)

    @staticmethod
    def backward(ctx, g):
        return recompute_backward(
            attention_reference,
            (*ctx.saved_tensors, ctx.scale, ctx.softmax_axis),
            ctx.needs_input_grad, g)


def _forward(q, k, v, scale, softmax_axis):
    """The plain version on CPU tensors, the kernel on CUDA tensors."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale, softmax_axis)
    what = "fused_attention"
    _build.require_cuda(what, q, k, v)
    if softmax_axis not in ("q", "k"):
        raise ValueError(f"{what}: softmax_axis must be 'q' or 'k'")
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{what}: q, k, v must share one (N, S, H, D) "
                         f"shape, got {q.shape}/{k.shape}/{v.shape}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{what}: q, k, v must share a dtype")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError(f"{what}: q, k, v need a unit stride on D")
    n, s, h, d = q.shape
    code = _build.dtype_code(q, what)
    out = torch.empty((n, s, h, d), dtype=q.dtype, device=q.device)
    axis_q = softmax_axis == "q"
    stats = torch.empty(2 * n * h * s, dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(*[
        st for t in (q, k, v, out)
        for st in (t.stride(0), t.stride(2), t.stride(1))])
    lib = _build.library("attention", _SIGNATURES)
    with _build.on_device(q.device):
        rc = lib.sdm_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            stats.data_ptr(), ctypes.cast(strides, ctypes.c_void_p), n, h,
            s, d, float(scale), int(axis_q), code,
            _build.stream_handle(q.device))
    if rc == _ERR_TOKENS:
        raise NotImplementedError(
            f"{what}: S={s} is past the longest grid the whole-S kernel "
            "takes; longer grids take streaming_attention (see whole_s_ok)")
    _build.check(lib, rc, what)
    fused_attention.launches += 1
    fused_attention.mma_launches += takes_mma(q, k, v)
    return out


def attention(q, k, v, scale: float, softmax_axis: str = "q",
              use_kernels: bool = True):
    """The layers' dispatcher over (N, S, H, D): `fused_attention` where
    `whole_s_ok`, else the streaming kernel on (N*H, S, D) (a view for one
    head, a copy for several); the plain version when `use_kernels` is
    False."""
    if not use_kernels:
        return attention_reference(q, k, v, scale, softmax_axis)
    if whole_s_ok(q, k, v):
        return fused_attention(q, k, v, scale, softmax_axis)
    n, s, h, d = q.shape
    if h == 1:
        out = streaming_attention(q[:, :, 0], k[:, :, 0], v[:, :, 0], scale,
                                  softmax_axis)
        return out.view(n, s, 1, d)
    to3d = lambda t: t.permute(0, 2, 1, 3).reshape(n * h, s, d)
    out = streaming_attention(to3d(q), to3d(k), to3d(v), scale, softmax_axis)
    return out.view(n, h, s, d).permute(0, 2, 1, 3).contiguous()
