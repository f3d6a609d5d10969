"""Self-attention over flattened H*W tokens, softmax over the query axis
("q", the reference's parity quirk) or the key axis ("k").

Port of sdm_tpu/kernels/attention.py::fused_attention (TPU kernel
`_attn_kernel`, sdm_tpu/kernels/attention.py:43-58, launched at :86). The
query-axis softmax has no library kernel: SDPA and flash attention
normalise over keys. The CUDA kernel (csrc/attention.cu) runs two passes on
both axes: softmax statistics over the whole reduced axis (column stats for
"q", row stats for "k"), then an apply pass that writes P V. bf16 at the U-Net's shapes runs on the tensor
cores (WMMA); fp32, and bf16 at other shapes, on fp32 CUDA cores. It is
bound by its 6*S*S*D operations per head (scores twice, P V once).

`attention_reference` is the plain PyTorch version (sdm_tpu's
`_xla_attention`): fp32 scores, fp32 softmax, P cast to v's dtype, P V with
fp32 accumulation. `attention()` is the dispatcher the layers call: with
`use_kernels`, shapes whose apply block fits in shared memory
(`whole_s_ok`, the C entry point's own formula mirrored) go to
`fused_attention` and longer grids to the streaming kernel
(kernels/streaming_attention.py); without it the plain version. The TPU's
`_AUTO_STREAMING_MIN_S` and `_whole_tile_ok` are not carried over. When a
gradient is wanted `fused_attention` runs as `FusedAttention`, whose
backward recomputes through `attention_reference` (sdm_tpu's VJP,
attention.py:193-199); streaming shapes differentiate through the streaming
kernels' own backward.
"""

from __future__ import annotations

import ctypes

import torch

from sdm_tpu_torch.kernels import _build
from sdm_tpu_torch.kernels._autograd import recompute_backward, wants_grad
from sdm_tpu_torch.kernels.streaming_attention import streaming_attention

_SIGNATURES = {
    "sdm_attention_forward": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
    "sdm_attention_fits": (ctypes.c_int, [ctypes.c_int, ctypes.c_int]),
}

# sdm_attention_forward's return when the apply pass's 32 x S block does not
# fit in shared memory (it then launches nothing).
_ERR_TOKENS = -1
# Opt-in shared memory per block on sm_90 (csrc/attention_tiles.cuh MAX_SMEM).
MAX_SMEM = 232448


def apply_smem_bytes(s: int, wmma: bool) -> int:
    """Shared memory of csrc/attention.cu's apply block at S = s: the bf16
    tensor-core kernel (wmma_apply_smem_bytes: P [32][S+8] bf16, eight
    16 x 16 fp32 tiles, a [64][136] bf16 staging area) or the CUDA-core one
    (apply_smem_bytes: [32][S+1] fp32 scores and 4096 staging floats)."""
    if wmma:
        return 32 * (s + 8) * 2 + 8 * 256 * 4 + 64 * 136 * 2
    return (32 * (s + 1) + 4096) * 4


def takes_wmma(q, k, v) -> bool:
    """csrc/attention.cu's wmma_ok for these (N, S, H, D) inputs: bf16,
    S % 64 == 0, D % 128 == 0, 16-byte aligned rows (the output is a fresh
    contiguous tensor and always qualifies)."""
    n, s, h, d = q.shape
    if q.dtype != torch.bfloat16 or s % 64 or d % 128:
        return False
    return all(t.data_ptr() % 16 == 0
               and all(t.stride(i) % 8 == 0 for i in range(3))
               for t in (q, k, v))


def whole_s_ok(q, k, v) -> bool:
    """Whether `fused_attention` takes these inputs: the mirror of
    sdm_attention_forward's admission (sdm_attention_fits in the C source).
    The dispatchers send everything else to the streaming kernel."""
    return apply_smem_bytes(q.shape[1], takes_wmma(q, k, v)) <= MAX_SMEM


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
    rc = lib.sdm_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        stats.data_ptr(), ctypes.cast(strides, ctypes.c_void_p), n, h, s, d,
        float(scale), int(axis_q), code, _build.stream_handle(q.device))
    if rc == _ERR_TOKENS:
        raise NotImplementedError(
            f"{what}: S={s} is too long for the kernel's shared-memory score "
            "block; longer grids take streaming_attention (see whole_s_ok)")
    _build.check(lib, rc, what)
    fused_attention.launches += 1
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
