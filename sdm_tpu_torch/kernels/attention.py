"""Self-attention over flattened H*W tokens, softmax over the query axis
("q", the reference's parity quirk) or the key axis ("k").

Port of sdm_tpu/kernels/attention.py::fused_attention (TPU kernel
`_attn_kernel`, sdm_tpu/kernels/attention.py:43-58, launched at :86). The
query-axis softmax has no library kernel: SDPA and flash attention
normalise over keys. The CUDA kernel (csrc/attention.cu) runs two passes on
both axes: softmax statistics over the whole reduced axis (column stats for
"q", row stats for "k"), then an apply pass that writes P V. bf16 at the
U-Net's shapes (`takes_wgmma`: S % 64 == 0, D % 64 == 0, D <= 1024, 16-byte
aligned bases and strides) runs on the tensor cores through TMA and wgmma:
the stats on `attn_stats_wgmma`, the apply on `attn_apply_wgmma`, split
over output columns as `wgmma_plan` says; each such call also counts in
`fused_attention.mma_launches` (the tensor-core count). fp32, and bf16 at
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
    MAX_SMEM, rows_aligned16, streaming_attention)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "sdm_attention_forward": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                   ctypes.c_float, _I, _I, _P]),
    "sdm_attention_fits": (_I, [_I, _I]),
    "sdm_attention_takes_wgmma": (_I, [_P, _P, _I, _I, _I]),
    "sdm_attention_wgmma_plan": (_I, [_I, _I, _I, _P]),
    "sdm_attention_wgmma_smem": (_I, [_I, _P]),
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
# csrc/attention.cu's tensor-core constants: kept rows (stats) and queries
# (apply) a block (WROWS), columns of D a chunk (WBOX), chunks a TMA load
# (WCHUNKS), the widest D (WMAX_D), the widest output-column slice of an
# apply block (WCOLS), reduced rows a stats load (WRED), the most ring
# stages of each kernel (WSTATS_STAGES, WAPPLY_STAGES) and the H100's SMs
# (WSMS).
WGMMA_ROWS, WGMMA_BOX, WGMMA_CHUNKS, WGMMA_MAX_D = 64, 64, 2, 1024
WGMMA_COLS, WGMMA_RED, WGMMA_STATS_STAGES, WGMMA_APPLY_STAGES = 512, 128, 8, 16
SMS = 132
_CHUNK_BYTES = WGMMA_ROWS * WGMMA_BOX * 2
_LOAD_BYTES = WGMMA_CHUNKS * _CHUNK_BYTES
_FIXED_BYTES = 1024 + 512     # alignment slack, barriers


def apply_smem_bytes(s: int) -> int:
    """Shared memory of csrc/attention.cu's CUDA-core apply block at S = s
    (apply_smem_bytes): [32][S+1] fp32 scores and 4096 staging floats."""
    return (32 * (s + 1) + 4096) * 4


def _chunks(d: int) -> int:
    """Chunks of D rounded up to whole loads (wgmma_chunks)."""
    return -(-(d // WGMMA_BOX) // WGMMA_CHUNKS) * WGMMA_CHUNKS


def wgmma_stages(d: int):
    """(stats, apply) ring stages at D = d (csrc/attention.cu
    wgmma_stats_stages, wgmma_apply_stages): as many as the shared memory
    leaves room for beside the resident 64-row tile (and the stats' 64
    (m, l) pairs of each warpgroup, the apply's two P tiles), at most 8
    stats stages of 128 rows x 2 chunks and 16 apply stages of 64 rows x 2
    chunks."""
    stats = (MAX_SMEM - _FIXED_BYTES - 2 * 2 * WGMMA_ROWS * 4
             - _chunks(d) * _CHUNK_BYTES) // (2 * _LOAD_BYTES)
    apply = (MAX_SMEM - _FIXED_BYTES
             - (_chunks(d) + 2) * _CHUNK_BYTES) // _LOAD_BYTES
    return min(stats, WGMMA_STATS_STAGES), min(apply, WGMMA_APPLY_STAGES)


def wgmma_smem_bytes(d: int):
    """(stats, apply) dynamic shared memory at D = d
    (wgmma_stats_smem_bytes, wgmma_apply_smem_bytes): alignment slack and
    barriers, the resident tile of D/64 chunks (rounded up to whole loads)
    of 64 x 64 bf16, and the ring; the stats also 1 KB of (m, l), the apply
    two P tiles."""
    stats, apply = wgmma_stages(d)
    return (_FIXED_BYTES + 2 * 2 * WGMMA_ROWS * 4 + _chunks(d) * _CHUNK_BYTES
            + stats * 2 * _LOAD_BYTES,
            _FIXED_BYTES + (_chunks(d) + 2) * _CHUNK_BYTES
            + apply * _LOAD_BYTES)


def admits_wgmma(dtype, s: int, d: int, ptrs, strides) -> bool:
    """csrc/attention.cu's wgmma_ok: bf16, S % 64 == 0, D % 64 == 0 with
    D <= 1024 and both kernels' shared memory within MAX_SMEM (two stats
    stages, and apply stages for the four V loads of a 512-column slice),
    16-byte aligned bases and N, H, S strides that are multiples of 8
    elements (TMA's strides, the 16-byte stores). `ptrs` and `strides`
    ((sn, sh, ss) in elements) of q, k, v and out."""
    if not (dtype == torch.bfloat16 and s > 0 and s % WGMMA_ROWS == 0
            and 0 < d <= WGMMA_MAX_D and d % WGMMA_BOX == 0):
        return False
    stats, apply = wgmma_stages(d)
    return (stats >= 2
            and apply >= WGMMA_COLS // WGMMA_BOX // WGMMA_CHUNKS
            and max(wgmma_smem_bytes(d)) <= MAX_SMEM
            and rows_aligned16(ptrs, strides))


def takes_wgmma(q, k, v) -> bool:
    """Whether these (N, S, H, D) inputs run on the tensor-core path. The
    output is a fresh contiguous (N, S, H, D) tensor: an aligned pointer and
    strides (S*H*D, D, H*D)."""
    n, s, h, d = q.shape
    return admits_wgmma(
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
    return fits(q.shape[1], takes_wgmma(q, k, v))


def wgmma_plan(bh: int, s: int, d: int):
    """csrc/attention.cu's wgmma_plan: (split, cols) of the tensor-core
    apply for bh = batch*heads rows of (S, D): `split` blocks per 64 queries,
    each `cols` output columns (whole 64-column chunks, at most 512). Each
    split recomputes Q K^T over all of D, so a block costs D + cols; the
    plan takes the least cost over waves of one block an SM on the 132 SMs
    (ties to the smaller split)."""
    boxes, blocks = d // WGMMA_BOX, bh * (s // WGMMA_ROWS)
    best = None
    for split in range(-(-d // WGMMA_COLS), boxes + 1):
        per = -(-boxes // split)
        if -(-boxes // per) != split:   # a smaller split's slices
            continue
        cost = -(-blocks * split // SMS) * (boxes + per)
        if best is None or cost < best[0]:
            best = (cost, split, per * WGMMA_BOX)
    return best[1], best[2]


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
    fused_attention.mma_launches += takes_wgmma(q, k, v)
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
