"""The whole attention block for heads == 1:

    qkv = tokens W_qkv^T + b_qkv        (cast to the compute dtype)
    q, k, v = split(qkv)
    r = attention(q, k, v)              (query or key axis)
    out = (r W_out^T + b_out) + tokens

Port of sdm_tpu/kernels/attention_block.py::fused_attention_block (TPU
kernel `_block_kernel`, sdm_tpu/kernels/attention_block.py:62-77, launched at
:88), which computes all of it in one VMEM-resident body. On the H100 a
whole-S block (`whole_s_ok`) is one C call, `sdm_attention_block_forward`
(csrc/attention_block.cu), which launches every kernel on the stream:

- bf16 at d_k = C = 512, S >= BFUSED_MIN_S, every operand as the tensor
  cores take it (`block_route` 2; the flagship's and the SR model's (1024,
  512) blocks): three launches, `linear_wgmma` for qkv, `attn_stats_wgmma`,
  and `attn_apply_wgmma` unsplit, which also runs the output projection,
  its bias and the residual on its own rows of r, so r never leaves the SM;
- otherwise four launches: the qkv GEMM (`linear`'s kernels, in bf16 at the
  U-Net's shapes `linear_wgmma`, TMA + wgmma), the whole-S attention's two
  passes (`fused_attention`'s kernels) into an r scratch, and the GEMM again
  with a bias + residual epilogue (`block_route` 1 where all of them run on
  the tensor cores, 0 where one takes the CUDA cores).

The wrapper allocates the output, the qkv (and r) scratch and the fp32
stats; `fused_attention_block.wgmma_launches` counts the calls of route 1
or 2, `fused_out_launches` those of route 2. Grids past `whole_s_ok` (the
256x256 SR model's S = 4096) take `_composed_block`: `linear`, the
streaming attention (csrc/streaming_attention.cu) and `linear` again, with
the rounding of sdm_tpu's composed path there (layers.py:303-317): qkv cast
after the fp32 bias, the attention output in the compute dtype, then the
output projection and the residual added in the compute dtype.

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
import functools

import torch

from sdm_tpu_torch.kernels import _build
from sdm_tpu_torch.kernels._autograd import recompute_backward, wants_grad
from sdm_tpu_torch.kernels.attention import (_ERR_TOKENS, admits_wgmma,
                                             attention_reference, fits,
                                             whole_s_ok)
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
_P, _I = ctypes.c_void_p, ctypes.c_int
_BLOCK_SIGNATURES = {
    "sdm_attention_block_forward": (_I, [
        _P, _P, _P, _I, _P, _P, _I, _P, _P, ctypes.c_longlong, _P, _I, _I,
        _I, _I, ctypes.c_float, _I, _I, _P]),
    "sdm_attention_block_route": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                       _I]),
}
# sdm_attention_block_forward's return when the scratch is not its route's
# (it then launches nothing).
_ERR_SCRATCH = -2
# csrc/attention_block.cu's fused route: d_k = C = BFUSED_D (the apply
# unsplit, NB = 4) and S >= BFUSED_MIN_S.
BFUSED_D = 512
BFUSED_MIN_S = 1024

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


def block_route(dtype, n: int, s: int, c: int, d_k: int, ptrs) -> int:
    """csrc/attention_block.cu's block_route for an (n, s, c) block with
    d_k: 2 the fused route (bf16, d_k = c = BFUSED_D, s >= BFUSED_MIN_S,
    every operand as the tensor cores take it: three launches, no r), 1
    every kernel on the tensor cores in four launches, 0 some kernel on the
    CUDA cores. `ptrs`: tokens, w_qkv, w_out, out and the scratch (qkv (n,
    s, 3 d_k), then r (n, s, d_k) at the element n s 3 d_k, counted in
    bf16 as the C code counts it). Only their offsets from 16 bytes
    matter, so the answer is kept per shape and offsets."""
    return _block_route(dtype, n, s, c, d_k, tuple(p % 16 for p in ptrs))


@functools.lru_cache(maxsize=None)
def _block_route(dtype, n, s, c, d_k, ptrs):
    tok, w_qkv, w_out, out, scratch = ptrs
    r = scratch + 2 * n * s * 3 * d_k
    qkv = (s * 3 * d_k, 3 * d_k, 3 * d_k)
    if not (linear_admits_wgmma(dtype, c, c, [tok, w_qkv, None])
            and admits_wgmma(dtype, s, d_k,
                             [scratch, scratch + 2 * d_k,
                              scratch + 4 * d_k, r],
                             [qkv] * 3 + [(s * d_k, d_k, d_k)])
            and fits(s, True)):
        return 0
    if (d_k == c == BFUSED_D and s >= BFUSED_MIN_S and w_out % 16 == 0
            and out % 16 == 0):
        return 2
    return 1 if linear_admits_wgmma(dtype, d_k, d_k, [r, w_out, tok]) else 0


def block_takes_fused_out(tokens, w_qkv, w_out) -> bool:
    """Whether the block's apply carries the output projection for these
    operands (`block_route` 2), the output and the scratch being fresh
    (aligned) tensors."""
    n, s, c = tokens.shape
    return block_route(tokens.dtype, n, s, c, w_out.shape[1],
                       (tokens.data_ptr(), w_qkv.data_ptr(),
                        w_out.data_ptr(), 0, 0)) == 2


def block_scratch_elems(n: int, s: int, d_k: int, route: int) -> int:
    """Elements of the block's scratch (the tokens' dtype): qkv, and r
    unless the apply carries the output projection (route 2)."""
    return n * s * (3 if route == 2 else 4) * d_k


def fused_attention_block(tokens, w_qkv, b_qkv, w_out, b_out, scale: float,
                          softmax_axis: str = "q"):
    """tokens (N, S, C) contiguous; w_qkv (3*d_k, C) and w_out (C, d_k) in
    tokens' dtype; b_qkv (3*d_k,), b_out (C,). Returns (N, S, C).

    CPU tensors run `attention_block_reference`; CUDA tensors make one C
    call at whole-S shapes (`_launch_block`) and launch `linear`, the
    streaming attention and `linear` again past them, or raise.
    Differentiable: `FusedAttentionBlock` at whole-S shapes, the composed
    path (`_composed_block`) past them."""
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
fused_attention_block.wgmma_launches = 0
fused_attention_block.fused_out_launches = 0


def _whole_s(tokens, w_out) -> bool:
    """`whole_s_ok` for the q, k, v views of the block's qkv buffer (a fresh
    contiguous (N, S, 1, 3*d_k) tensor), decided before it exists; kept per
    shape, dtype and predicate."""
    return _whole_s_shape(whole_s_ok, *tokens.shape[:2], w_out.shape[1],
                          tokens.dtype)


@functools.lru_cache(maxsize=None)
def _whole_s_shape(predicate, n, s, d_k, dtype) -> bool:
    qkv = torch.empty((n, s, 1, 3 * d_k), dtype=dtype, device="meta")
    return predicate(*qkv.split(d_k, dim=-1))


class FusedAttentionBlock(torch.autograd.Function):
    """The one-call forward; the backward differentiates
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
    on its own (the block past `whole_s_ok`)."""
    n, s, c = tokens.shape
    d_k = w_out.shape[1]
    tok2 = tokens.reshape(n * s, c)
    qkv = linear(tok2, w_qkv, b_qkv).view(n, s, 3 * d_k)
    q, k, v = qkv.split(d_k, dim=-1)
    r = streaming_attention(q, k, v, scale, softmax_axis)
    return linear(r.reshape(n * s, d_k), w_out, b_out,
                  residual=tok2).view(n, s, c)


def _launch_block(tokens, w_qkv, b_qkv, w_out, b_out, scale, softmax_axis):
    """The block on CUDA tensors: one C call at whole-S shapes,
    `_composed_block` past them."""
    if not _whole_s(tokens, w_out):
        return _composed_block(tokens, w_qkv, b_qkv, w_out, b_out, scale,
                               softmax_axis)
    what = "fused_attention_block"
    _build.require_cuda(what, tokens, w_qkv, b_qkv, w_out, b_out)
    if softmax_axis not in ("q", "k"):
        raise ValueError(f"{what}: softmax_axis must be 'q' or 'k'")
    if tokens.ndim != 3 or not tokens.is_contiguous():
        raise ValueError(f"{what}: tokens must be a contiguous (N, S, C)")
    n, s, c = tokens.shape
    d_k = w_out.shape[1]
    if w_qkv.shape != (3 * d_k, c) or w_out.shape != (c, d_k):
        raise ValueError(f"{what}: w_qkv must be ({3 * d_k}, {c}) and w_out "
                         f"({c}, {d_k}), got {w_qkv.shape}/{w_out.shape}")
    if b_qkv.shape != (3 * d_k,) or b_out.shape != (c,):
        raise ValueError(f"{what}: b_qkv must be ({3 * d_k},) and b_out "
                         f"({c},)")
    if w_qkv.dtype != tokens.dtype or w_out.dtype != tokens.dtype:
        raise ValueError(f"{what}: weights must be in the tokens' dtype "
                         f"{tokens.dtype}")
    if not all(t.is_contiguous() for t in (w_qkv, b_qkv, w_out, b_out)):
        raise ValueError(f"{what}: weights and biases must be contiguous")
    code = _build.dtype_code(tokens, what)
    out = torch.empty_like(tokens)
    route = block_route(tokens.dtype, n, s, c, d_k,
                        (tokens.data_ptr(), w_qkv.data_ptr(),
                         w_out.data_ptr(), out.data_ptr(), 0))
    scratch = torch.empty(block_scratch_elems(n, s, d_k, route),
                          dtype=tokens.dtype, device=tokens.device)
    stats = torch.empty(2 * n * s, dtype=torch.float32, device=tokens.device)
    lib = _build.library("attention_block", _BLOCK_SIGNATURES)
    with _build.on_device(tokens.device):
        rc = lib.sdm_attention_block_forward(
            tokens.data_ptr(), w_qkv.data_ptr(), b_qkv.data_ptr(),
            _build.dtype_code(b_qkv, what), w_out.data_ptr(),
            b_out.data_ptr(), _build.dtype_code(b_out, what), out.data_ptr(),
            scratch.data_ptr(), scratch.numel(), stats.data_ptr(), n, s, c,
            d_k, float(scale), int(softmax_axis == "q"), code,
            _build.stream_handle(tokens.device))
    if rc == _ERR_TOKENS:
        raise NotImplementedError(
            f"{what}: S={s} is past the longest grid the whole-S kernel "
            "takes (see whole_s_ok)")
    if rc == _ERR_SCRATCH:
        raise RuntimeError(f"{what}: the C route disagrees with block_route "
                           f"({route}) on the scratch it needs")
    _build.check(lib, rc, what)
    fused_attention_block.wgmma_launches += route >= 1
    fused_attention_block.fused_out_launches += route == 2
    return out
