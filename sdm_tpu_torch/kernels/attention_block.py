"""The whole attention block for heads == 1:

    qkv = tokens W_qkv^T + b_qkv        (cast to the compute dtype)
    q, k, v = split(qkv)
    r = attention(q, k, v)              (query or key axis)
    out = (r W_out^T + b_out) + tokens

Port of sdm_tpu/kernels/attention_block.py::fused_attention_block (TPU
kernel `_block_kernel`, sdm_tpu/kernels/attention_block.py:62-77, launched at
:88), which computes all of it in one VMEM-resident body. On the H100 the
block's weights do not fit one SM beside the token tile, so it runs as three
hand-written kernels: `linear` (csrc/linear.cu, a tiled GEMM with a bias
epilogue; in bf16 at the U-Net's shapes `linear_wgmma` on the tensor cores,
fed by TMA through an mbarrier ring into wgmma, `linear_takes_wgmma`) for
the qkv projection,
`fused_attention` (csrc/attention.cu) on
views of the qkv buffer, and `linear` again with a bias + residual epilogue.
Grids whose apply block does not fit in shared memory (`whole_s_ok`; the
256x256 SR model's S = 4096) take `streaming_attention`
(csrc/streaming_attention.cu) for the middle step instead, with the rounding
of sdm_tpu's composed path there (layers.py:303-317): qkv cast after the
fp32 bias, the attention output in the compute dtype, then the output
projection and the residual added in the compute dtype.
The GEMMs and the attention bound it by operations; a single-launch
fusion is later work.

Weights are in nn.Linear layout: w_qkv (3*d_k, C), w_out (C, d_k), in the
tokens' dtype; biases (fp32 or the tokens' dtype) are added in fp32.
`attention_block_reference` and `linear_reference` are the plain versions
(sdm_tpu's `_xla_block` and its TorchLinear products).

Gradients. At whole-S shapes the block runs as `FusedAttentionBlock`, whose
backward recomputes through `attention_block_reference` (sdm_tpu's VJP,
attention_block.py:152-158). Past `whole_s_ok` there is no whole-block
Function: sdm_tpu's block kernel never admits such grids, and its layer
takes the streaming `attention()` instead. So the block composes `linear`
(a Function whose backward is plain matmuls), the streaming Function
(kernels/streaming_attention.py, whose backward is the dV, dK and dQ
kernels) and `linear` again: the streaming residuals m and l come from the
one forward, and no S x S matrix exists in either direction.
"""

from __future__ import annotations

import ctypes

import torch

from sdm_tpu_torch.kernels import _build
from sdm_tpu_torch.kernels._autograd import recompute_backward, wants_grad
from sdm_tpu_torch.kernels.attention import (attention_reference,
                                             fused_attention, whole_s_ok)
from sdm_tpu_torch.kernels.streaming_attention import streaming_attention

_SIGNATURES = {
    "sdm_linear_forward": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]),
    "sdm_linear_takes_wgmma": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int]),
    "sdm_linear_wgmma_tile": (ctypes.c_int, [ctypes.c_int, ctypes.c_int]),
}

# csrc/linear.cu's tensor-core tiles: the K depth of a ring stage (LBK, one
# 128-byte swizzled row of bf16); per tile its consumer warpgroups, width
# and ring depth: the large (LWG, LBN, LSTAGES) and the small one for grids
# that would leave SMs idle (LWG_SMALL, LBN_SMALL, LSTAGES_SMALL); the
# persistent blocks an SM (LBLOCKS) and the SMs (LSMS).
LINEAR_BK = 64
LINEAR_TILES = ((2, 128, 3), (2, 64, 4))
LINEAR_BLOCKS = 2
LINEAR_SMS = 132


def linear_wgmma_smem_bytes(tile) -> int:
    """linear_wgmma's dynamic shared memory for a tile (warpgroups, BN,
    stages) of LINEAR_TILES (csrc/linear.cu's linear_wgmma_smem): 1024 bytes
    of alignment slack, the ring (each stage the tile's 64 x warpgroups x
    rows and BN W rows of LINEAR_BK bf16), and a full and an empty mbarrier
    (8 bytes each) per stage."""
    wg, bn, stages = tile
    return 1024 + stages * (64 * wg + bn) * LINEAR_BK * 2 + 2 * stages * 8


def linear_admits_wgmma(dtype, k: int, ldx: int, ptrs) -> bool:
    """csrc/linear.cu's linear_wgmma_ok, what TMA needs: bf16, K > 0 and
    K % 8 == 0 and ldx % 8 == 0 (16-byte row strides of W and x), and
    16-byte aligned pointers (`ptrs`: x, w and the residual, or None where
    there is none). K need not be a multiple of LINEAR_BK: TMA zero-fills
    the last box's columns past K."""
    return (dtype == torch.bfloat16 and k > 0 and k % 8 == 0
            and ldx % 8 == 0
            and all(p is None or p % 16 == 0 for p in ptrs))


def linear_takes_wgmma(x, weight, residual=None) -> bool:
    """Whether `linear` runs these operands on the tensor-core path."""
    ptrs = [x.data_ptr(), weight.data_ptr(),
            None if residual is None else residual.data_ptr()]
    return linear_admits_wgmma(x.dtype, x.shape[1], x.stride(0), ptrs)


def linear_wgmma_tile(m: int, n: int) -> int:
    """csrc/linear.cu's linear_wgmma_tile: the index into LINEAR_TILES of an
    m x n output's tile, 0 (the large) where it cuts the output into at
    least LINEAR_SMS tiles, else 1."""
    wg, bn, _ = LINEAR_TILES[0]
    tiles = -(-m // (64 * wg)) * -(-n // bn)
    return 0 if tiles >= LINEAR_SMS else 1


def linear_reference(x, weight, bias, residual=None):
    """Plain version: (x W^T + b) in fp32, rounded to x's dtype, then
    `+ residual` in x's dtype."""
    y = torch.nn.functional.linear(x.to(torch.float32),
                                   weight.to(torch.float32),
                                   bias.to(torch.float32)).to(x.dtype)
    return y if residual is None else y + residual


def linear(x, weight, bias, residual=None):
    """x (M, K) with a unit column stride; weight (N, K) contiguous in x's
    dtype; bias (N,); residual (M, N) contiguous in x's dtype or None.
    Returns (M, N) in x's dtype.

    CPU tensors run `linear_reference`; CUDA tensors launch csrc/linear.cu
    or raise; launches on the tensor-core path (`linear_takes_wgmma`, the
    wgmma kernel) also count in `linear.mma_launches`. Differentiable
    (`Linear`)."""
    if wants_grad(x, weight, bias, residual):
        return Linear.apply(x, weight, bias, residual)
    return _linear_forward(x, weight, bias, residual)


linear.launches = 0
linear.mma_launches = 0


class Linear(torch.autograd.Function):
    """The kernel forward; the backward is the plain version's own gradient
    in plain matmuls: the output's fp32 rounding point passes g through as
    fp32, dx = g W and dW = g^T x in fp32, db = sum g, each cast to its
    input's dtype, and the residual takes g as it is."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual):
        ctx.save_for_backward(x, weight)
        ctx.bias_dtype = bias.dtype
        return _linear_forward(x, weight, bias, residual)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        need_x, need_w, need_b, need_r = ctx.needs_input_grad
        g32 = g.to(torch.float32)
        dx = (torch.matmul(g32, weight.to(torch.float32)).to(x.dtype)
              if need_x else None)
        dw = (torch.matmul(g32.t(), x.to(torch.float32)).to(weight.dtype)
              if need_w else None)
        db = g32.sum(dim=0).to(ctx.bias_dtype) if need_b else None
        return dx, dw, db, (g if need_r else None)


def _linear_forward(x, weight, bias, residual):
    """The plain version on CPU tensors, the kernel on CUDA tensors."""
    if x.device.type == "cpu":
        return linear_reference(x, weight, bias, residual)
    what = "linear"
    extra = (residual,) if residual is not None else ()
    _build.require_cuda(what, x, weight, bias, *extra)
    m, k = x.shape
    n = weight.shape[0]
    if weight.shape != (n, k) or bias.shape != (n,):
        raise ValueError(f"{what}: weight must be ({n}, {k}) and bias ({n},)")
    if x.stride(1) != 1 or not (weight.is_contiguous()
                                and bias.is_contiguous()):
        raise ValueError(f"{what}: x needs a unit column stride, weight and "
                         "bias must be contiguous")
    if weight.dtype != x.dtype:
        raise ValueError(f"{what}: weight dtype {weight.dtype} != x dtype "
                         f"{x.dtype}")
    if residual is not None and (residual.shape != (m, n)
                                 or residual.dtype != x.dtype
                                 or not residual.is_contiguous()):
        raise ValueError(f"{what}: residual must be a contiguous ({m}, {n}) "
                         f"{x.dtype} tensor")
    code = _build.dtype_code(x, what)
    bias_code = _build.dtype_code(bias, what)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = _build.library("linear", _SIGNATURES)
    with _build.on_device(x.device):
        rc = lib.sdm_linear_forward(
            x.data_ptr(), x.stride(0), weight.data_ptr(), bias.data_ptr(),
            bias_code, residual.data_ptr() if residual is not None else None,
            out.data_ptr(), m, n, k, code, _build.stream_handle(x.device))
    _build.check(lib, rc, what)
    linear.launches += 1
    linear.mma_launches += linear_takes_wgmma(x, weight, residual)
    return out


def attention_block_reference(tokens, w_qkv, b_qkv, w_out, b_out,
                              scale: float, softmax_axis: str = "q"):
    """Plain version. tokens (N, S, C) -> (N, S, C) in tokens' dtype."""
    n, s, c = tokens.shape
    d_k = w_out.shape[1]
    dtype = tokens.dtype
    qkv = linear_reference(tokens, w_qkv.to(dtype), b_qkv)
    q, k, v = qkv.reshape(n, s, 1, 3 * d_k).split(d_k, dim=-1)
    r = attention_reference(q, k, v, scale, softmax_axis).reshape(n, s, d_k)
    return linear_reference(r, w_out.to(dtype), b_out, residual=tokens)


def fused_attention_block(tokens, w_qkv, b_qkv, w_out, b_out, scale: float,
                          softmax_axis: str = "q"):
    """tokens (N, S, C) contiguous; w_qkv (3*d_k, C) and w_out (C, d_k) in
    tokens' dtype; b_qkv (3*d_k,), b_out (C,). Returns (N, S, C).

    CPU tensors run `attention_block_reference`; CUDA tensors launch the
    linear kernel, the whole-S or the streaming attention kernels, and the
    linear kernel again, or raise. Differentiable: `FusedAttentionBlock` at
    whole-S shapes, the composed path (`_composed_block`) past them."""
    args = (tokens, w_qkv, b_qkv, w_out, b_out, scale, softmax_axis)
    if tokens.device.type != "cpu":
        # Counted before the launches: a checkpoint's replay (the U-Net's
        # "remat") may stop inside the block's last autograd node, after
        # its kernels ran but before this call returns.
        fused_attention_block.launches += 1
    if not wants_grad(*args):
        if tokens.device.type == "cpu":
            return attention_block_reference(*args)
        return _launch_block(*args)
    if _whole_s(tokens, w_out):
        return FusedAttentionBlock.apply(*args)
    return _composed_block(*args)


fused_attention_block.launches = 0


def _whole_s(tokens, w_out) -> bool:
    """`whole_s_ok` for the q, k, v views of the block's qkv buffer (a fresh
    contiguous (N, S, 1, 3*d_k) tensor), decided before it exists."""
    n, s, _ = tokens.shape
    d_k = w_out.shape[1]
    qkv = torch.empty((n, s, 1, 3 * d_k), dtype=tokens.dtype, device="meta")
    return whole_s_ok(*qkv.split(d_k, dim=-1))


class FusedAttentionBlock(torch.autograd.Function):
    """The three-launch forward; the backward differentiates
    `attention_block_reference` on the saved inputs."""

    @staticmethod
    def forward(ctx, tokens, w_qkv, b_qkv, w_out, b_out, scale, softmax_axis):
        ctx.save_for_backward(tokens, w_qkv, b_qkv, w_out, b_out)
        ctx.scale, ctx.softmax_axis = scale, softmax_axis
        if tokens.device.type == "cpu":
            return attention_block_reference(tokens, w_qkv, b_qkv, w_out,
                                             b_out, scale, softmax_axis)
        return _launch_block(tokens, w_qkv, b_qkv, w_out, b_out, scale,
                             softmax_axis)

    @staticmethod
    def backward(ctx, g):
        return recompute_backward(
            attention_block_reference,
            (*ctx.saved_tensors, ctx.scale, ctx.softmax_axis),
            ctx.needs_input_grad, g)


def _composed_block(tokens, w_qkv, b_qkv, w_out, b_out, scale, softmax_axis):
    """linear, streaming attention, linear + residual, each differentiable
    on its own (the block's training path past `whole_s_ok`)."""
    n, s, c = tokens.shape
    d_k = w_out.shape[1]
    tok2 = tokens.reshape(n * s, c)
    qkv = linear(tok2, w_qkv, b_qkv).view(n, s, 3 * d_k)
    q, k, v = qkv.split(d_k, dim=-1)
    r = streaming_attention(q, k, v, scale, softmax_axis)
    return linear(r.reshape(n * s, d_k), w_out, b_out,
                  residual=tok2).view(n, s, c)


def _launch_block(tokens, w_qkv, b_qkv, w_out, b_out, scale, softmax_axis):
    """The three launches of `fused_attention_block` on CUDA tensors."""
    what = "fused_attention_block"
    _build.require_cuda(what, tokens, w_qkv, b_qkv, w_out, b_out)
    if tokens.ndim != 3 or not tokens.is_contiguous():
        raise ValueError(f"{what}: tokens must be a contiguous (N, S, C)")
    n, s, c = tokens.shape
    d_k = w_out.shape[1]
    if w_qkv.shape != (3 * d_k, c) or w_out.shape != (c, d_k):
        raise ValueError(f"{what}: w_qkv must be ({3 * d_k}, {c}) and w_out "
                         f"({c}, {d_k}), got {w_qkv.shape}/{w_out.shape}")
    tok2 = tokens.view(n * s, c)
    qkv = linear(tok2, w_qkv, b_qkv).view(n, s, 1, 3 * d_k)
    q, k, v = qkv.split(d_k, dim=-1)
    if whole_s_ok(q, k, v):
        r = fused_attention(q, k, v, scale, softmax_axis)
    else:
        r = streaming_attention(q[:, :, 0], k[:, :, 0], v[:, :, 0], scale,
                                softmax_axis)
    out = linear(r.reshape(n * s, d_k), w_out, b_out, residual=tok2)
    return out.view(n, s, c)
