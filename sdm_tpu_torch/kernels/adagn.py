"""Fused AdaGN: GroupNorm statistics + GN affine + FiLM modulation.

Port of sdm_tpu/kernels/adagn.py::fused_adagn (TPU kernel `_adagn_kernel`,
sdm_tpu/kernels/adagn.py:32-76, launched at :115), which holds a sample in
VMEM and reads it from HBM once. The CUDA kernels are csrc/adagn.cu; each
call takes the route `adagn_plan` gives (a mirror of the C plan):

- `ONE_PASS` (bf16 x and output, C % 8 == 0, C <= 1024, G <= 32): one
  cooperative launch of `adagn_grid`, a block an SM (a row of a sample a
  block at least), in teams of blocks, one a sample where the samples in
  flight fit 64 MiB. A block streams its
  rows of a sample through a ring of bulk copies for their Welford
  statistics, publishes its group partials, meets its team at the
  sample's counter, merges the team's partials (Chan, fixed order), then
  reads its rows again while they are in L2 and writes `(x - mean)*a + b`.
  Its partials and counters live in buffers kept per device and stream
  (`grid_buffers`), so a call allocates its output alone.
- `TWO_PASS` (fp32, or a shape the one-pass kernel does not take): a
  statistics pass and an apply pass over a (chunks, N) grid
  (`adagn_chunks`).

`fused_adagn.one_pass_launches` counts the calls on the one-pass kernel,
`fused_adagn.two_pass_launches` the others; `fused_adagn.launches` counts
both. Admission is the port's own (the TPU's VMEM budget and C % 128 rule
are not carried over). `adagn_reference` is the plain PyTorch version
(sdm_tpu's `_xla_adagn`); the wrapper takes it only for CPU tensors. When
a gradient is wanted the call runs as `FusedAdaGN`, whose backward
recomputes through `adagn_reference` (sdm_tpu's VJP, adagn.py:167-175).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import torch

from sdm_tpu_torch.kernels import _build
from sdm_tpu_torch.kernels._autograd import recompute_backward, wants_grad
from sdm_tpu_torch.ops.norms import group_norm

_SIGNATURES = {
    "sdm_adagn_forward": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]),
    "sdm_adagn_plan": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
}

# SMs of the H100, and the statistics blocks per SM `adagn_chunks` aims at.
SMS = 132
WAVES = 2
# Most (chunk, group) partials of one sample: the apply pass stages them in
# shared memory, 8 bytes each, within the 48 KB a block has without opt-in.
MAX_PARTIALS = 4096

# csrc/adagn.cu's one-pass kernel: threads a block; its settings (ADAGN_*,
# which only tools/torch_adagn_tiles.py builds otherwise): bytes a bulk
# copy, ring slots, bytes of the samples in flight that set the teams; its
# largest C and G; a block's and an SM's shared memory, and what each
# resident block reserves of it.
THREADS = 256
PIECE_BYTES = 65536
SLOTS = 3
TEAM_BYTES = 64 << 20
MAX_C = 1024
MAX_GROUPS = 32
MAX_SMEM = 232448
SM_SMEM = 233472
BLOCK_RESERVED = 1024

TWO_PASS, ONE_PASS = 0, 1


class Plan(NamedTuple):
    """csrc/adagn.cu's AdagnPlan: the route; the grid's blocks; for the one
    pass, rows a bulk copy, dynamic shared memory and teams; for the two
    passes, the row ranges a sample."""
    route: int
    blocks: int
    piece_rows: int
    smem: int
    teams: int
    chunks: int


def adagn_chunks(n: int, hw: int, groups: int) -> int:
    """Row ranges per sample of csrc/adagn.cu's two passes: about WAVES
    blocks per SM over the (chunks, N) grid, at most one per row, and at
    most MAX_PARTIALS partials per sample."""
    return max(1, min(-(-WAVES * SMS // n), hw, MAX_PARTIALS // groups))


def onepass_smem(data_bytes: int, nbars: int, c: int, groups: int) -> int:
    """csrc/adagn.cu's onepass_smem total: the ring's bytes, the mbarriers
    (8 bytes each, padded to 16), the row lanes' (mean, M2) (2 x THREADS x
    8 fp32), the channels' (2 x C fp32), the group partials (G float2) and
    the merged mean and 1 / std (2 x G fp32)."""
    return (data_bytes + -(-nbars * 8 // 16) * 16 + 2 * THREADS * 8 * 4
            + 2 * c * 4 + groups * 8 + 2 * groups * 4)


def onepass_ok(x_dtype, out_dtype, c: int, groups: int) -> bool:
    """What the one-pass kernel takes: bf16 x and output, C % 8 == 0 (16-
    byte rows), C % G == 0, C <= MAX_C (two row lanes at least) and
    G <= MAX_GROUPS (eight merge lanes a group in 256 threads)."""
    return (x_dtype == torch.bfloat16 and out_dtype == torch.bfloat16
            and 1 <= groups <= MAX_GROUPS and c % 8 == 0 and c % groups == 0
            and c <= MAX_C)


@functools.lru_cache(maxsize=1024)
def adagn_plan(n: int, hw: int, c: int, groups: int, x_dtype, out_dtype,
               sms: int = SMS) -> Plan:
    """csrc/adagn.cu's make_plan on a card of `sms` SMs. ONE_PASS where
    `onepass_ok` and it fits: teams = min(N, TEAM_BYTES // (hw 2C), one at
    least, sms), each of min(sms // teams, hw) blocks (a block an SM, a row
    of a sample a block at least); rings of SLOTS pieces of PIECE_BYTES.
    Else TWO_PASS. Memoized: a call's plan costs the wrapper a lookup."""
    chunks = adagn_chunks(n, hw, groups)
    two_pass = Plan(TWO_PASS, chunks * n, 0, 0, 0, chunks)
    if not onepass_ok(x_dtype, out_dtype, c, groups):
        return two_pass
    row = 2 * c
    teams = min(sms, max(1, min(n, TEAM_BYTES // (hw * row))))
    team_size = min(sms // teams, hw)
    piece_rows = max(1, PIECE_BYTES // row)
    smem = onepass_smem(SLOTS * piece_rows * row, SLOTS, c, groups)
    if (team_size < 1 or (team_size + 1) * hw >= 1 << 31
            or smem > MAX_SMEM or smem + BLOCK_RESERVED > SM_SMEM):
        return two_pass
    return Plan(ONE_PASS, teams * team_size, piece_rows, smem, teams, 0)


def scratch_floats(plan: Plan, n: int, groups: int) -> int:
    """fp32 values of the partials a plan needs: (N, chunks, G, 2) for
    TWO_PASS, (N, team_size, G, 2) for ONE_PASS (which also takes 2 N
    64-bit counters, `grid_buffers`)."""
    if plan.route == ONE_PASS:
        return 2 * n * (plan.blocks // plan.teams) * groups
    return 2 * n * plan.chunks * groups


_SMS = {}
_GRID_BUFFERS = {}
_GRID_LOCK = threading.Lock()


def sm_count(device: torch.device) -> int:
    """SMs of a CUDA device (cached)."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SMS[index]


def grid_buffers(device: torch.device, stream: int, floats: int,
                 samples: int):
    """The one-pass kernel's partials (fp32, `floats` at least) and counters
    (int64 read as unsigned, 2 `samples` at least) for a (device, stream),
    kept between calls: the counters are zeroed once and every launch
    leaves them at zero, and launches of one stream run in order. Larger
    ones replace them (the counters zeroed)."""
    key = (device, stream)
    with _GRID_LOCK:
        part, cnt = _GRID_BUFFERS.get(key, (None, None))
        if part is None or part.numel() < floats:
            part = torch.empty(floats, dtype=torch.float32, device=device)
        if cnt is None or cnt.numel() < 2 * samples:
            cnt = torch.zeros(2 * samples, dtype=torch.int64, device=device)
        _GRID_BUFFERS[key] = (part, cnt)
    return part, cnt


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

    CPU tensors run `adagn_reference`; CUDA tensors launch csrc/adagn.cu
    (the route `adagn_plan` gives) or raise. Differentiable
    (`FusedAdaGN`)."""
    args = (x, gn_scale, gn_bias, mod_scale, mod_shift, num_groups, eps)
    if wants_grad(*args):
        return FusedAdaGN.apply(*args)
    return _forward(*args)


fused_adagn.launches = 0
fused_adagn.one_pass_launches = 0
fused_adagn.two_pass_launches = 0


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
    if (gn_scale.shape != (c,) or gn_bias.shape != (c,)
            or gn_scale.dtype != gn_bias.dtype
            or not (gn_scale.is_contiguous() and gn_bias.is_contiguous())):
        raise ValueError(f"{what}: GroupNorm affine must be two contiguous "
                         f"({c},) tensors of one dtype")
    rows = mod_scale.shape[0]
    if (mod_scale.shape != mod_shift.shape or mod_scale.ndim != 2
            or mod_scale.shape[1] != c or rows not in (1, n)
            or mod_scale.dtype != mod_shift.dtype
            or mod_scale.stride() != mod_shift.stride()
            or mod_scale.stride(1) != 1):
        raise ValueError(f"{what}: FiLM tables must be ({n}, {c}) or "
                         f"(1, {c}) of one dtype and row layout with unit "
                         f"channel stride, got {mod_scale.shape}/"
                         f"{mod_shift.shape}")
    out_dtype = torch.promote_types(x.dtype, mod_scale.dtype)
    codes = [_build.dtype_code(t, what) for t in (x, gn_scale, mod_scale)]
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    out_code = _build.dtype_code(out, what)
    sms = sm_count(x.device) if x.dtype == torch.bfloat16 else SMS
    plan = adagn_plan(n, h * w, c, num_groups, x.dtype, out_dtype, sms)
    floats = scratch_floats(plan, n, num_groups)
    stream = _build.stream_handle(x.device)
    if plan.route == ONE_PASS:
        scratch, counters = grid_buffers(x.device, stream, floats, n)
    else:
        scratch = torch.empty(floats, dtype=torch.float32, device=x.device)
        counters = None
    lib = _build.library("adagn", _SIGNATURES)
    with _build.on_device(x.device):
        rc = lib.sdm_adagn_forward(
            x.data_ptr(), gn_scale.data_ptr(), gn_bias.data_ptr(),
            mod_scale.data_ptr(), mod_shift.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), scratch.numel(),
            None if counters is None else counters.data_ptr(),
            0 if counters is None else counters.numel(),
            n, h * w, c, num_groups, float(eps),
            0 if rows == 1 else mod_scale.stride(0),
            *codes, out_code, stream)
    _build.check(lib, rc, what)
    fused_adagn.launches += 1
    if plan.route == ONE_PASS:
        fused_adagn.one_pass_launches += 1
    else:
        fused_adagn.two_pass_launches += 1
    return out
