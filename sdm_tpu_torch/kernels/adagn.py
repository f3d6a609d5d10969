"""Fused AdaGN: GroupNorm statistics + GN affine + FiLM modulation.

Port of sdm_tpu/kernels/adagn.py::fused_adagn (TPU kernel `_adagn_kernel`,
sdm_tpu/kernels/adagn.py:32-76, launched at :115). The CUDA kernel is
csrc/adagn.cu, two launches over a (chunks, N) grid of row ranges
(`adagn_chunks`): a statistics pass that reads x once in 16-byte vectors,
keeps per-channel Welford statistics and merges them (Chan's formula) into
per-(sample, chunk, group) partials, and an apply pass that merges those
partials, folds GN affine and FiLM into per-channel a, b and writes
`(x - mean)*a + b`. On the H100 it is bound by device-memory bytes: x read
and the output written once each, plus the statistics' read of x.

Admission is the port's own: every shape with C % groups == 0 and C % 8 == 0
goes to the kernel (the TPU's VMEM budget and C % 128 rule are not carried
over). `adagn_reference` is the plain PyTorch version (sdm_tpu's
`_xla_adagn`); the wrapper takes it only for CPU tensors. When a gradient is
wanted the call runs as `FusedAdaGN`, whose backward recomputes through
`adagn_reference` (sdm_tpu's VJP, adagn.py:167-175).
"""

from __future__ import annotations

import ctypes

import torch

from sdm_tpu_torch.kernels import _build
from sdm_tpu_torch.kernels._autograd import recompute_backward, wants_grad
from sdm_tpu_torch.ops.norms import group_norm

_SIGNATURES = {
    "sdm_adagn_forward": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]),
}

# SMs of the H100, and the statistics blocks per SM `adagn_chunks` aims at.
SMS = 132
WAVES = 2
# Most (chunk, group) partials of one sample: the apply pass stages them in
# shared memory, 8 bytes each, within the 48 KB a block has without opt-in.
MAX_PARTIALS = 4096


def adagn_chunks(n: int, hw: int, groups: int) -> int:
    """Row ranges per sample of csrc/adagn.cu's two passes: about WAVES
    blocks per SM over the (chunks, N) grid, at most one per row, and at
    most MAX_PARTIALS partials per sample."""
    return max(1, min(-(-WAVES * SMS // n), hw, MAX_PARTIALS // groups))


def adagn_reference(x, gn_scale, gn_bias, mod_scale, mod_shift,
                    num_groups: int, eps: float = 1e-5):
    """Plain version: group_norm, then mod_scale * x_gn + mod_shift.

    x (N, H, W, C); gn_scale/gn_bias (C,); mod_scale/mod_shift (N, C) or
    (1, C). The output dtype is the promotion of x and the FiLM tables."""
    x_gn = group_norm(x, gn_scale, gn_bias, num_groups, eps)
    return mod_scale[:, None, None, :] * x_gn + mod_shift[:, None, None, :]


def fused_adagn(x, gn_scale, gn_bias, mod_scale, mod_shift,
                num_groups: int, eps: float = 1e-5):
    """x (N, H, W, C) contiguous; gn_scale/gn_bias (C,); mod_scale/mod_shift
    (N, C) or (1, C), rows contiguous. Returns (N, H, W, C) in the promotion
    of x's and the FiLM tables' dtypes.

    CPU tensors run `adagn_reference`; CUDA tensors launch csrc/adagn.cu or
    raise. Differentiable (`FusedAdaGN`)."""
    args = (x, gn_scale, gn_bias, mod_scale, mod_shift, num_groups, eps)
    if wants_grad(*args):
        return FusedAdaGN.apply(*args)
    return _forward(*args)


fused_adagn.launches = 0


class FusedAdaGN(torch.autograd.Function):
    """The kernel forward; the backward differentiates `adagn_reference` on
    the saved inputs."""

    @staticmethod
    def forward(ctx, x, gn_scale, gn_bias, mod_scale, mod_shift, num_groups,
                eps):
        ctx.save_for_backward(x, gn_scale, gn_bias, mod_scale, mod_shift)
        ctx.num_groups, ctx.eps = num_groups, eps
        return _forward(x, gn_scale, gn_bias, mod_scale, mod_shift,
                        num_groups, eps)

    @staticmethod
    def backward(ctx, g):
        return recompute_backward(
            adagn_reference, (*ctx.saved_tensors, ctx.num_groups, ctx.eps),
            ctx.needs_input_grad, g)


def _forward(x, gn_scale, gn_bias, mod_scale, mod_shift, num_groups, eps):
    """The plain version on CPU tensors, the kernel on CUDA tensors."""
    if x.device.type == "cpu":
        return adagn_reference(x, gn_scale, gn_bias, mod_scale, mod_shift,
                               num_groups, eps)
    what = "fused_adagn"
    _build.require_cuda(what, x, gn_scale, gn_bias, mod_scale, mod_shift)
    if x.ndim != 4:
        raise ValueError(f"{what}: x must be (N, H, W, C), got {x.shape}")
    n, h, w, c = x.shape
    if c % num_groups != 0 or c % 8 != 0:
        raise ValueError(f"{what}: C={c} must divide into {num_groups} "
                         "groups and be a multiple of 8")
    if not x.is_contiguous() or x.data_ptr() % 16 != 0:
        raise ValueError(f"{what}: x must be contiguous and 16-byte aligned")
    if gn_scale.shape != (c,) or gn_bias.shape != (c,):
        raise ValueError(f"{what}: GroupNorm affine must be ({c},)")
    if gn_scale.dtype != gn_bias.dtype or not (gn_scale.is_contiguous()
                                               and gn_bias.is_contiguous()):
        raise ValueError(f"{what}: GroupNorm affine must share a dtype and "
                         "be contiguous")
    rows = mod_scale.shape[0]
    if (mod_scale.shape != mod_shift.shape or mod_scale.ndim != 2
            or mod_scale.shape[1] != c or rows not in (1, n)):
        raise ValueError(f"{what}: FiLM tables must be ({n}, {c}) or "
                         f"(1, {c}), got {mod_scale.shape}/{mod_shift.shape}")
    if (mod_scale.dtype != mod_shift.dtype or mod_scale.stride(1) != 1
            or mod_shift.stride(1) != 1
            or mod_scale.stride(0) != mod_shift.stride(0)):
        raise ValueError(f"{what}: FiLM tables must share a dtype and a "
                         "row layout with unit channel stride")
    out_dtype = torch.promote_types(x.dtype, mod_scale.dtype)
    codes = [_build.dtype_code(t, what) for t in (x, gn_scale, mod_scale)]
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    out_code = _build.dtype_code(out, what)
    chunks = adagn_chunks(n, h * w, num_groups)
    scratch = torch.empty((n, chunks, num_groups, 2), dtype=torch.float32,
                          device=x.device)
    row_stride = 0 if rows == 1 else mod_scale.stride(0)
    lib = _build.library("adagn", _SIGNATURES)
    with _build.on_device(x.device):
        rc = lib.sdm_adagn_forward(
            x.data_ptr(), gn_scale.data_ptr(), gn_bias.data_ptr(),
            mod_scale.data_ptr(), mod_shift.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), n, h * w, c, num_groups, chunks, float(eps),
            row_stride,
            *codes, out_code, _build.stream_handle(x.device))
    _build.check(lib, rc, what)
    fused_adagn.launches += 1
    return out
