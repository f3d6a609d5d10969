#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (sdm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure (the script exits non-zero on any):

  1. Device and build: the card's name and power limit (nvidia-smi), TF32
     off for the fp32 comparisons, and every kernel built from
     sdm_tpu_torch/csrc (one nvcc per source, all at once).
  2. Kernels vs plain: each hand-written kernel held against its plain
     PyTorch version at every shape the flagship 128x128 U-Net and the
     256x256 super-resolution (SR) U-Net give it, batch 16, fp32 and bf16,
     both softmax axes (each attention check also against the wrong axis,
     which must fail); kernel, plain and library times and the least time
     the card could take (bound). The streaming kernels run at the SR
     model's S = 4096 and at S = 1024, where the whole-S kernel is a second
     reference.
  3. Model: the flagship and the SR U-Net from seeded random weights,
     use_kernels=True against use_kernels=False, one call at batch 16
     (t=500), fp32 and bf16, and a profiler breakdown of one bf16 call each.
  4. Serving, the cascade: the flagship exported as a BASE bundle and
     served over HTTP by DiffusionServer over SamplerEngine(ddim, step 20 =
     DDIM-50, batch 16, bf16); a 16-image request and two small requests
     that coalesce. Its 16 images then become the low-resolution inputs of
     an SR bundle (seeded random weights, cond_t 250) served the same way
     (cold sampling, step 20: 51 U-Net calls, bf16, batch 16), the images
     sent as raw floats (lr_image_b64 + lr_shape). Around each path's
     requests the kernels' launch counters are zeroed just before and read
     just after, and held to the counts its U-Net calls imply. Then one
     more batch of each is traced with the profiler for the device's busy
     share.

Prints a `kernels` JSON line, then as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Per-shape results also go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import base64
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

# H100 SXM published peaks (dense): HBM bytes/s, bf16 tensor-core and fp32
# CUDA-core FLOP/s.
PEAK_BYTES = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}

BATCH = 16
IMG = 128
# The flagship U-Net (bench.py flagship_net): 128x128x3, min/max channel
# 128/512, 4 layers, attention on layers 2 and 3, one head, time_dim 512.
FLAGSHIP = dict(num_resnet_blocks=1, in_channel=3, out_channel=3,
                time_dim=512, cond_dim=None, num_layers=4, attn_layers=(2, 3),
                num_heads=1, dim_per_head=None, groups=32, min_channel=128,
                max_channel=512, image_recon=False)
GROUPS = 32
# (H, W, C) of every AdaGN in one U-Net call (each twice: two per
# ResidualBlock) and (S, C) of every attention block (each once).
ADAGN_SHAPES = [(128, 128, 128), (64, 64, 256), (32, 32, 512), (16, 16, 512),
                (8, 8, 1024), (16, 16, 1024), (32, 32, 768), (64, 64, 384)]
ADAGN_PER_CALL = 2
BLOCK_SHAPES = [(1024, 512), (256, 512), (64, 1024), (256, 1024)]
DDIM_STEP = 20
# The SR model (bench.py sr_net): 256x256 output from 6 input channels (the
# noisy image and the q-sampled upsampled LR image), tanh out; otherwise
# the flagship's widths. Served with cold sampling, step 20 (51 calls).
SR_IMG = 256
SR = dict(FLAGSHIP, in_channel=6, image_recon=True)
SR_COND_T = 250
SR_ADAGN_SHAPES = [(256, 256, 128), (128, 128, 256), (64, 64, 512),
                   (32, 32, 512), (16, 16, 1024), (32, 32, 1024),
                   (64, 64, 1024), (128, 128, 512)]
# (S, C) of the SR model's attention blocks: down layers 2 and 3, up layers
# 3 and 2. S = 4096 is past the whole-S kernel's shared memory and streams.
SR_BLOCK_SHAPES = [(4096, 512), (1024, 512), (256, 1024), (1024, 1024)]
# Streaming attention checks, (S, D): the SR shape, and one the whole-S
# kernel also takes.
STREAM_SHAPES = [(4096, 512), (1024, 512)]
# Tolerances, |kernel - plain| <= atol + rtol*|plain| + of_max*max|plain|.
# fp32: both sides accumulate in fp32 in another order. bf16 AdaGN: the
# plain version rounds at more places (GN output, FiLM product and sum),
# each a possible one-ulp flip of the element itself.
TOL = {"float32": dict(atol=1e-4, rtol=1e-3, of_max=0.0),
       "bfloat16": dict(atol=2e-2, rtol=2e-2, of_max=0.0)}
# bf16 attention and attention block: besides the output's own rounding
# (at most 2^-7 of the element), a one-ulp flip of a bf16 intermediate (a P
# entry when the fp32 scores differ in the last bit; qkv, r, r W_out + b)
# moves an element by an amount set by the output's scale, not by the
# element. The wrong-axis controls show that this bound sees the axis.
ATTN_TOL = {"float32": TOL["float32"],
            "bfloat16": dict(atol=0.0, rtol=1e-2, of_max=1e-2)}
# q and k std: scores std QK_STD**2 = 2.25, spread over several units, so
# the q- and k-axis softmaxes differ and the checks can tell them apart.
QK_STD = 1.5
# Streaming stats vs their plain version: both sum fp32 scores (the same
# bf16 or fp32 products) in another order; m is a max of such scores, l a
# sum of S exponentials.
STATS_TOL = {"m": dict(atol=1e-4, rtol=1e-5, of_max=0.0),
             "l": dict(atol=0.0, rtol=1e-4, of_max=0.0)}
# U-Net kernels-on vs kernels-off, normwise relative error of one call.
MODEL_TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, reps: int) -> float:
    """Mean device ms of fn over `reps` launches (CUDA events), warmed up."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare(name, got, want, tol):
    import torch
    got = got.float()
    want = want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    diff = (got - want).abs()
    max_abs = diff.max().item()
    # Relative to the output's scale: elementwise ratios blow up where the
    # plain value is near zero.
    scale = want.abs().max().item()
    max_rel = max_abs / max(scale, 1e-30)
    bad = (diff > tol["atol"] + tol["rtol"] * want.abs()
           + tol["of_max"] * scale).sum().item()
    if bad:
        raise AssertionError(
            f"{name}: {bad} elements outside {tol_text(tol)} (max abs "
            f"{max_abs:.3e})")
    return max_abs, max_rel


def must_fail(name, got, wrong, tol):
    """Negative control: `got` held against the plain version with the other
    softmax axis must fail `compare`, or the check could not see the axis."""
    try:
        compare(name, got, wrong, tol)
    except AssertionError:
        return
    raise AssertionError(f"{name}: the wrong softmax axis passes "
                         f"{tol_text(tol)}; the check cannot see the axis")


def tol_text(tol) -> str:
    return f"atol {tol['atol']} rtol {tol['rtol']} of_max {tol['of_max']}"


def err_text(err, tol) -> str:
    return f"err abs {err[0]:.2e} rel {err[1]:.2e} (tol {tol_text(tol)})"


def bound_ms(bytes_moved: float, ops: float, dtype_name: str):
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------- phase 2

def kernel_phase(torch, results):
    import torch.nn.functional as F
    from sdm_tpu_torch.kernels.adagn import adagn_reference, fused_adagn
    from sdm_tpu_torch.kernels.attention import (attention_reference,
                                                 fused_attention)
    from sdm_tpu_torch.kernels import streaming_attention as sa
    from sdm_tpu_torch.kernels.attention_block import (
        attention_block_reference, fused_attention_block)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(shape, dtype, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * std
                + mean).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        isz = torch.tensor([], dtype=dtype).element_size()
        adagn = [("flagship", sh) for sh in ADAGN_SHAPES] + [
            ("sr", sh) for sh in SR_ADAGN_SHAPES if sh not in ADAGN_SHAPES]
        for model, (h, w, c) in adagn:
            x = randn((BATCH, h, w, c), dtype, std=2.0, mean=0.5)
            gamma = randn((c,), dtype, std=0.1, mean=1.0)
            beta = randn((c,), dtype, std=0.1)
            # The main path's FiLM tables are (1, C): t is one step.
            s = randn((1, c), dtype, std=0.5, mean=1.0)
            t = randn((1, c), dtype, std=0.5)
            args = (x, gamma, beta, s, t, GROUPS)
            got = fused_adagn(*args)
            want = adagn_reference(*args)
            err = compare(f"adagn {dn} {h}x{w}x{c}", got, want, TOL[dn])
            reps = 20
            ms = time_ms(lambda: fused_adagn(*args), reps)
            plain = time_ms(lambda: adagn_reference(*args), reps)
            xc = x.permute(0, 3, 1, 2)          # NCHW channels_last view
            s4, t4 = s[:, :, None, None], t[:, :, None, None]
            lib = time_ms(lambda: F.group_norm(xc, GROUPS, gamma, beta)
                          * s4 + t4, reps)
            nbytes = BATCH * h * w * c * 2 * isz + 4 * c * isz
            ops = BATCH * h * w * c * 8.0
            b, by = bound_ms(nbytes, ops, "float32")
            results.append(dict(kernel="adagn", model=model, dtype=dn,
                                shape=[BATCH, h, w, c],
                                max_abs_err=err[0], max_rel_err=err[1],
                                tol=TOL[dn], ms=ms, plain_ms=plain,
                                library_ms=lib, bound_ms=b, bound_by=by))
            log(f"adagn {dn:8s} {h:3d}x{w:3d}x{c:4d}  {err_text(err, TOL[dn])}  "
                f"kernel {ms:.4f} ms  plain {plain:.4f}  "
                f"group_norm+FiLM {lib:.4f}  bound {b:.4f} ({by})")
            del x, args

        cases = [("flagship", sh) for sh in BLOCK_SHAPES] + [
            ("sr", sh) for sh in SR_BLOCK_SHAPES if sh not in BLOCK_SHAPES]
        for model, (s_len, d) in cases:
            for axis in ("q", "k"):
                if s_len <= 1024:   # the whole-S kernel; S = 4096 streams
                    attention_case(torch, randn, results, model, dtype,
                                   s_len, d, axis)
                block_case(torch, randn, results, model, dtype, s_len, d,
                           axis)

        for (s_len, d) in STREAM_SHAPES:
            for axis in ("q", "k"):
                streaming_case(torch, randn, results, dtype, s_len, d, axis)

    # Shapes off the tensor-core path (S % 64, D % 128, K % 32 != 0) take
    # the CUDA-core kernels in bf16 too.
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for axis in ("q", "k"):
            c = 72
            bnd = 1.0 / math.sqrt(c)
            args = (randn((2, 100, c), dtype, std=QK_STD),
                    randn((3 * c, c), dtype, std=bnd),
                    randn((3 * c,), dtype, std=bnd), randn((c, c), dtype, std=bnd),
                    randn((c,), dtype, std=bnd), c ** -0.5, axis)
            err = compare(f"attention_block {dn} S=100 C=72 {axis}",
                          fused_attention_block(*args),
                          attention_block_reference(*args), ATTN_TOL[dn])
            log(f"attention_block {dn:8s} S= 100 C=  72 {axis} (CUDA-core "
                f"path)  {err_text(err, ATTN_TOL[dn])}")
            q, k, v = (randn((2, 300, 72), dtype, std=QK_STD)
                       for _ in range(3))
            err = compare(f"streaming {dn} S=300 D=72 {axis}",
                          sa.streaming_attention(q, k, v, 0.1, axis),
                          sa.streaming_attention_reference(q, k, v, 0.1,
                                                           axis),
                          ATTN_TOL[dn])
            log(f"streaming {dn:8s} S= 300 D=  72 {axis} (CUDA-core path, "
                f"ragged tiles)  {err_text(err, ATTN_TOL[dn])}")
            # Tensor-core layouts off the main path: D = 128 leaves three of
            # the four column warps idle; D = 1024 splits the output columns
            # over two blocks and the key tile into two chunks.
            for d in (128, 1024):
                q, k, v = (randn((2, 256, d), dtype, std=QK_STD)
                           for _ in range(3))
                err = compare(f"streaming {dn} S=256 D={d} {axis}",
                              sa.streaming_attention(q, k, v, d ** -0.5,
                                                     axis),
                              sa.streaming_attention_reference(
                                  q, k, v, d ** -0.5, axis), ATTN_TOL[dn])
                log(f"streaming {dn:8s} S= 256 D={d:4d} {axis}  "
                    f"{err_text(err, ATTN_TOL[dn])}")

    # Multi-head attention (heads > 1 goes to fused_attention itself):
    # q/k/v as strided views of one qkv buffer, as the layer passes them.
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        qkv = randn((BATCH, 256, 4, 3 * 128), dtype, std=QK_STD)
        q, k, v = qkv.split(128, dim=-1)
        for axis in ("q", "k"):
            got = fused_attention(q, k, v, 128 ** -0.5, axis)
            want = attention_reference(q, k, v, 128 ** -0.5, axis)
            err = compare(f"attention {dn} heads=4 {axis}", got, want,
                          ATTN_TOL[dn])
            log(f"attention {dn:8s} S=256 H=4 D=128 {axis} (strided views)  "
                f"{err_text(err, ATTN_TOL[dn])}")

    # The dispatchers' predicate mirrors the C entry point's formula.
    from sdm_tpu_torch.kernels import _build
    from sdm_tpu_torch.kernels import attention as attn_mod
    lib = _build.library("attention", attn_mod._SIGNATURES)
    for s_len in range(64, 8193, 8):
        for wmma in (0, 1):
            mirror = attn_mod.apply_smem_bytes(s_len, bool(wmma)) \
                <= attn_mod.MAX_SMEM
            if bool(lib.sdm_attention_fits(s_len, wmma)) != mirror:
                raise AssertionError(f"whole_s_ok's mirror disagrees with "
                                     f"sdm_attention_fits at S={s_len}")
    log("whole-S predicate: the Python mirror agrees with "
        "sdm_attention_fits for S = 64..8192")
    # S beyond the apply pass's shared memory is refused, launching nothing.
    long_seq = torch.zeros((1, 2048, 1, 8), device=dev)
    try:
        fused_attention(long_seq, long_seq, long_seq, 1.0, "q")
    except NotImplementedError as e:
        log(f"attention float32 S=2048: refused ({e})")
    else:
        raise AssertionError("attention: float32 S=2048 was not refused")


def _reps(s_len, dtype_name):
    """Timed launches per measurement: fewer for the long fp32 grids."""
    if s_len >= 4096:
        return 2 if dtype_name == "float32" else 5
    return 10


def attention_case(torch, randn, results, model, dtype, s_len, d, axis):
    import torch.nn.functional as F
    from sdm_tpu_torch.kernels.attention import (attention_reference,
                                                 fused_attention)
    dn = str(dtype).split(".")[-1]
    isz = torch.tensor([], dtype=dtype).element_size()
    other = "k" if axis == "q" else "q"
    q, k = (randn((BATCH, s_len, 1, d), dtype, std=QK_STD) for _ in range(2))
    v = randn((BATCH, s_len, 1, d), dtype)
    scale = d ** -0.5
    got = fused_attention(q, k, v, scale, axis)
    want = attention_reference(q, k, v, scale, axis)
    name = f"attention {dn} S={s_len} D={d} {axis}"
    err = compare(name, got, want, ATTN_TOL[dn])
    must_fail(name, got, attention_reference(q, k, v, scale, other),
              ATTN_TOL[dn])
    reps = _reps(s_len, dn)
    ms = time_ms(lambda: fused_attention(q, k, v, scale, axis), reps)
    plain = time_ms(lambda: attention_reference(q, k, v, scale, axis), reps)
    lib = None
    if axis == "k":
        qh, kh, vh = (a.transpose(1, 2) for a in (q, k, v))
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, scale=scale), reps)
    nbytes = 4 * BATCH * s_len * d * isz
    ops = 4.0 * BATCH * s_len * s_len * d
    b, by = bound_ms(nbytes, ops, dn)
    results.append(dict(kernel="attention", model=model, dtype=dn, axis=axis,
                        shape=[BATCH, s_len, 1, d],
                        max_abs_err=err[0], max_rel_err=err[1],
                        tol=ATTN_TOL[dn], ms=ms, plain_ms=plain,
                        library_ms=lib, bound_ms=b, bound_by=by))
    log(f"attention {dn:8s} S={s_len:4d} D={d:4d} {axis}  "
        f"{err_text(err, ATTN_TOL[dn])}  wrong axis fails  "
        f"kernel {ms:.4f} ms  plain {plain:.4f}  "
        f"sdpa {lib if lib is None else round(lib, 4)}  "
        f"bound {b:.4f} ({by})")


def block_case(torch, randn, results, model, dtype, s_len, d, axis):
    from sdm_tpu_torch.kernels.attention_block import (
        attention_block_reference, fused_attention_block)
    dn = str(dtype).split(".")[-1]
    isz = torch.tensor([], dtype=dtype).element_size()
    other = "k" if axis == "q" else "q"
    # Tokens of std QK_STD give q and k of about that std.
    c = d
    tok = randn((BATCH, s_len, c), dtype, std=QK_STD)
    bnd = 1.0 / math.sqrt(c)
    w_qkv = randn((3 * d, c), dtype, std=bnd)
    b_qkv = randn((3 * d,), dtype, std=bnd)
    w_out = randn((c, d), dtype, std=bnd)
    b_out = randn((c,), dtype, std=bnd)
    args = (tok, w_qkv, b_qkv, w_out, b_out, d ** -0.5, axis)
    got = fused_attention_block(*args)
    want = attention_block_reference(*args)
    name = f"attention_block {dn} S={s_len} C={c} {axis}"
    err = compare(name, got, want, ATTN_TOL[dn])
    must_fail(name, got, attention_block_reference(*args[:-1], other),
              ATTN_TOL[dn])
    reps = _reps(s_len, dn)
    ms = time_ms(lambda: fused_attention_block(*args), reps)
    plain = time_ms(lambda: attention_block_reference(*args), reps)
    nbytes = (2 * BATCH * s_len * c + 4 * c * d) * isz
    ops = (2.0 * BATCH * s_len * c * 4 * d
           + 4.0 * BATCH * s_len * s_len * d)
    b, by = bound_ms(nbytes, ops, dn)
    results.append(dict(kernel="attention_block", model=model, dtype=dn,
                        axis=axis, shape=[BATCH, s_len, c],
                        max_abs_err=err[0], max_rel_err=err[1],
                        tol=ATTN_TOL[dn], ms=ms, plain_ms=plain,
                        library_ms=None, bound_ms=b, bound_by=by))
    log(f"attention_block {dn:8s} S={s_len:4d} C={c:4d} {axis}  "
        f"{err_text(err, ATTN_TOL[dn])}  wrong axis fails  "
        f"kernel {ms:.4f} ms  plain {plain:.4f}  bound {b:.4f} ({by})")


def streaming_case(torch, randn, results, dtype, s_len, d, axis):
    """The streaming stats and apply kernels, each against its plain version
    on the same inputs (the apply pass on the kernel's own m and l), and the
    whole function against the plain one and the wrong axis; at S = 1024
    also against the whole-S kernel."""
    import torch.nn.functional as F
    from sdm_tpu_torch.kernels import streaming_attention as sa
    from sdm_tpu_torch.kernels.attention import fused_attention
    dn = str(dtype).split(".")[-1]
    isz = torch.tensor([], dtype=dtype).element_size()
    other = "k" if axis == "q" else "q"
    q, k = (randn((BATCH, s_len, d), dtype, std=QK_STD) for _ in range(2))
    v = randn((BATCH, s_len, d), dtype)
    scale = d ** -0.5
    tag = f"{dn} S={s_len} D={d} {axis}"

    m, l = sa.streaming_stats(q, k, scale, axis)
    m_ref, l_ref = sa.streaming_stats_reference(q, k, scale, axis)
    err_m = compare(f"streaming_stats m {tag}", m, m_ref, STATS_TOL["m"])
    err_l = compare(f"streaming_stats l {tag}", l, l_ref, STATS_TOL["l"])
    out = sa.streaming_apply(q, k, v, m, l, scale, axis)
    err_a = compare(f"streaming_apply {tag}", out,
                    sa.streaming_apply_reference(q, k, v, m, l, scale, axis),
                    ATTN_TOL[dn])
    full = sa.streaming_attention(q, k, v, scale, axis)
    err_f = compare(f"streaming_attention {tag}", full,
                    sa.streaming_attention_reference(q, k, v, scale, axis),
                    ATTN_TOL[dn])
    must_fail(f"streaming_attention {tag}", full,
              sa.streaming_attention_reference(q, k, v, scale, other),
              ATTN_TOL[dn])
    line = (f"streaming {tag}: m {err_text(err_m, STATS_TOL['m'])}; l "
            f"{err_text(err_l, STATS_TOL['l'])}; apply "
            f"{err_text(err_a, ATTN_TOL[dn])}; whole function "
            f"{err_text(err_f, ATTN_TOL[dn])}; wrong axis fails")
    if s_len <= 1024:
        whole = fused_attention(q[:, :, None], k[:, :, None], v[:, :, None],
                                scale, axis)[:, :, 0]
        err_w = compare(f"streaming vs whole-S {tag}", full, whole,
                        ATTN_TOL[dn])
        line += f"; vs the whole-S kernel {err_text(err_w, ATTN_TOL[dn])}"
    log(line)

    reps = _reps(s_len, dn)
    ms_s = time_ms(lambda: sa.streaming_stats(q, k, scale, axis), reps)
    ms_a = time_ms(lambda: sa.streaming_apply(q, k, v, m, l, scale, axis),
                   reps)
    pl_s = time_ms(lambda: sa.streaming_stats_reference(q, k, scale, axis),
                   reps)
    pl_a = time_ms(lambda: sa.streaming_apply_reference(q, k, v, m, l, scale,
                                                        axis), reps)
    lib = None
    if axis == "k":
        qh, kh, vh = (a[:, None] for a in (q, k, v))
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, scale=scale), reps)
    flops = float(BATCH) * s_len * s_len * d
    stat_bytes = 2 * BATCH * s_len * 4
    b_s, by_s = bound_ms(2 * BATCH * s_len * d * isz + stat_bytes,
                         2 * flops, dn)
    b_a, by_a = bound_ms(4 * BATCH * s_len * d * isz + stat_bytes,
                         4 * flops, dn)
    b_f, by_f = bound_ms(4 * BATCH * s_len * d * isz, 4 * flops, dn)
    common = dict(model="sr", dtype=dn, axis=axis, shape=[BATCH, s_len, d])
    results.append(dict(common, kernel="streaming_stats",
                        max_abs_err=max(err_m[0], err_l[0]),
                        max_rel_err=max(err_m[1], err_l[1]),
                        tol=STATS_TOL, ms=ms_s, plain_ms=pl_s,
                        library_ms=None, bound_ms=b_s, bound_by=by_s))
    results.append(dict(common, kernel="streaming_apply",
                        max_abs_err=err_a[0], max_rel_err=err_a[1],
                        tol=ATTN_TOL[dn], ms=ms_a, plain_ms=pl_a,
                        library_ms=None, bound_ms=b_a, bound_by=by_a))
    results.append(dict(common, kernel="streaming_attention",
                        max_abs_err=err_f[0], max_rel_err=err_f[1],
                        tol=ATTN_TOL[dn], ms=ms_s + ms_a,
                        plain_ms=pl_s + pl_a, library_ms=lib, bound_ms=b_f,
                        bound_by=by_f))
    log(f"streaming {tag}: stats {ms_s:.4f} ms (plain {pl_s:.4f}, bound "
        f"{b_s:.4f} {by_s}), apply {ms_a:.4f} ms (plain {pl_a:.4f}, bound "
        f"{b_a:.4f} {by_a}); sdpa {lib if lib is None else round(lib, 4)}")


# --------------------------------------------------------------- phase 3

def model_phase(torch, name, cfg, img):
    """One U-Net call (t=500, batch 16) with kernels against without, in
    fp32 and bf16; a profiler breakdown of the bf16 call."""
    from sdm_tpu_torch.models import UNet
    dev = torch.device("cuda")
    x = torch.randn((BATCH, img, img, cfg["in_channel"]),
                    generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev)
    t = torch.tensor([500], device=dev)
    report = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        torch.manual_seed(0)
        net_k = UNet(**cfg, dtype=dtype if dtype != torch.float32
                     else None, use_kernels=True)
        net_p = UNet(**cfg, dtype=dtype if dtype != torch.float32
                     else None, use_kernels=False)
        net_p.load_state_dict(net_k.state_dict())
        nets = [n.to(dev, dtype, memory_format=torch.channels_last).eval()
                for n in (net_k, net_p)]
        with torch.inference_mode():
            out_k, out_p = (n(x, t).float() for n in nets)
            torch.cuda.synchronize()
            ms_k = time_ms(lambda: nets[0](x, t), 3)
            ms_p = time_ms(lambda: nets[1](x, t), 3)
        if out_k.shape != (BATCH, img, img, cfg["out_channel"]) or \
                not torch.isfinite(out_k).all():
            raise AssertionError(f"{name} U-Net {dn}: bad output "
                                 f"{out_k.shape}")
        rel = ((out_k - out_p).norm() / out_p.norm()).item()
        max_abs = (out_k - out_p).abs().max().item()
        log(f"{name} unet {dn:8s} kernels vs plain: normwise rel {rel:.3e} "
            f"(tol {MODEL_TOL[dn]}), max abs {max_abs:.3e}, "
            f"|out| max {out_p.abs().max().item():.3e}; one call "
            f"{ms_k:.2f} ms with kernels, {ms_p:.2f} ms plain")
        if not rel <= MODEL_TOL[dn]:
            raise AssertionError(f"{name} U-Net {dn}: kernels vs plain rel "
                                 f"{rel}")
        report[dn] = dict(rel_err=rel, max_abs_err=max_abs, ms_kernels=ms_k,
                          ms_plain=ms_p)
        if dtype == torch.bfloat16:      # the served configuration
            with torch.inference_mode():
                split = device_breakdown(torch, lambda: nets[0](x, t))
            report[dn]["device_breakdown"] = split
            if split is None:
                log(f"{name} unet bfloat16 device breakdown: not measured "
                    "(the profiler trace holds no device time)")
            else:
                log(f"{name} unet bfloat16 device breakdown of one call "
                    f"(profiler): {split['total_ms']:.3f} ms in "
                    f"{split['launches']} kernel launches; " + ", ".join(
                        f"{k} {v:.3f} ms" for k, v in
                        sorted(split["families"].items(),
                               key=lambda kv: -kv[1])))
                for k in split["top"]:
                    log(f"  {k['ms']:8.3f} ms  x{k['count']:<4d} {k['name']}")
        del nets, net_k, net_p, out_k, out_p
        torch.cuda.empty_cache()
    return report


# Kernel-name fragments -> family for the device-time breakdown; the first
# match wins, so the streaming kernels (stream_apply*, and the shared stats
# kernels tagged <streaming>) come before the whole-S attention, and the
# port's kernels and cuDNN's convolutions before cuBLAS's GEMMs.
FAMILIES = (("adagn_", "adagn (port)"),
            ("stream", "streaming attention (port)"),
            ("attn_", "attention (port)"),
            ("linear_", "linear (port)"), ("fprop", "conv (cuDNN)"),
            ("dgrad", "conv (cuDNN)"), ("conv", "conv (cuDNN)"),
            ("implicit", "conv (cuDNN)"), ("gemm", "matmul (cuBLAS)"))


def device_breakdown(torch, fn):
    """Device time of one fn() by kernel family, and the top kernels, from
    a torch.profiler trace; None when the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    total = sum(ms for _, ms, _ in kernels)
    if total <= 0:
        return None
    families = {}
    for name, ms, _ in kernels:
        fam = next((f for frag, f in FAMILIES if frag in name.lower()),
                   "other (elementwise, copies)")
        families[fam] = families.get(fam, 0.0) + ms
    top = sorted(kernels, key=lambda k: -k[1])[:10]
    return dict(total_ms=total, launches=sum(c for _, _, c in kernels),
                families=families,
                top=[dict(name=n[:100], ms=ms, count=c) for n, ms, c in top])


# --------------------------------------------------------------- phase 4

def _post(url, payload, timeout=600):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _images(resp):
    import numpy as np
    arr = np.frombuffer(base64.b64decode(resp["data_b64"]), np.float32)
    return arr.reshape(resp["shape"])


def _export(torch, tmp, name, cfg, img, model_type, cond_t=None):
    """cfg's U-Net from seed 0 exported as a one-entry bundle (steps
    1..1000, the linear schedule 5e-3 -> 9e-3); returns its config.json."""
    from sdm_tpu_torch.cli.export_models import export_bundle
    from sdm_tpu_torch.models import UNet
    torch.manual_seed(0)
    net = UNet(**cfg)
    pt = os.path.join(tmp, f"{name}.pt")
    torch.save({"model": net.state_dict()}, pt)
    train = dict(in_channel=cfg["in_channel"], out_channel=cfg["out_channel"],
                 num_layers=cfg["num_layers"],
                 num_resnet_block=cfg["num_resnet_blocks"],
                 attn_layers=list(cfg["attn_layers"]),
                 attn_heads=cfg["num_heads"],
                 attn_dim_per_head=cfg["dim_per_head"],
                 time_dim=cfg["time_dim"], cond_dim=cfg["cond_dim"],
                 min_channel=cfg["min_channel"],
                 max_channel=cfg["max_channel"],
                 img_recon=cfg["image_recon"],
                 min_noise_step=1, max_noise_step=1000,
                 noise_scheduler="LINEAR", beta1=5e-3, betaT=9e-3)
    if cond_t is not None:
        train["cond_t"] = cond_t
    bundle = export_bundle(name, tmp, img_c=3, img_h=img, img_w=img,
                           model_type=model_type, entries=[(train, pt)])
    return os.path.join(bundle, "config.json")


def expected_launches(cfg, calls, streaming):
    """Launches per kernel for `calls` U-Net calls of cfg: two AdaGN per
    ResidualBlock and one attention block per ResidualBlock of an
    attention layer, down and up; each block runs `linear` twice and one
    attention, whole-S or (for the `streaming` blocks) the two streaming
    passes."""
    adagn = 2 * 2 * cfg["num_layers"] * cfg["num_resnet_blocks"]
    blocks = 2 * len(cfg["attn_layers"]) * cfg["num_resnet_blocks"]
    return {"fused_adagn": adagn * calls,
            "fused_attention": (blocks - streaming) * calls,
            "fused_attention_block": blocks * calls,
            "linear": 2 * blocks * calls,
            "streaming_stats": streaming * calls,
            "streaming_apply": streaming * calls}


def serve_requests(torch, engine, counters, requests):
    """Serve `requests` over HTTP, in the order the phase needs: the first
    alone, the next two together (they coalesce), the last alone. The launch
    counters are zeroed just before the first request and read just after
    the last. Returns (images per request, launches, stats, seconds of the
    first request)."""
    from sdm_tpu_torch.serving import DiffusionServer
    server = DiffusionServer(engine, port=0, batch_wait_ms=200.0,
                             log=lambda *a: None)
    server.start(precompile=True)
    try:
        url = f"http://{server.host}:{server.port}/generate"
        got = {}

        def send(i):
            got[i] = _images(_post(url, requests[i]))

        for fn in counters:
            fn.launches = 0
        t0 = time.monotonic()
        send(0)
        t_first = time.monotonic() - t0
        threads = [threading.Thread(target=send, args=(i,)) for i in (1, 2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(600)
            if th.is_alive():
                raise AssertionError("coalesced request timed out")
        send(3)
        launches = {fn.__name__: fn.launches for fn in counters}
        stats = engine.stats.snapshot()
    finally:
        server.stop()
    return [got[i] for i in range(4)], launches, stats, t_first


def check_served(name, images, requests, img, launches, stats, cfg,
                 streaming):
    import numpy as np
    for i, (arr, req) in enumerate(zip(images, requests)):
        n = req["num_images"]
        if arr.shape != (n, img, img, 3) or not np.isfinite(arr).all():
            raise AssertionError(f"{name} request {i}: shape {arr.shape} or "
                                 "non-finite values")
    diff = float(np.abs(images[1] - images[3]).max())
    log(f"{name}: 3-image request coalesced vs alone: max abs diff "
        f"{diff:.3e}")
    if diff > 1e-3:
        raise AssertionError(f"{name}: coalesced and lone images differ")
    batches = stats["batches"]
    if batches != 3:
        raise AssertionError(f"{name}: expected 3 batches (16, 3+5 "
                             f"coalesced, 3 alone), got {batches}")
    calls = batches * (1000 // DDIM_STEP + 1)
    expect = expected_launches(cfg, calls, streaming)
    log(f"{name}: served launches {launches}, expected {expect} "
        f"({batches} batches x {calls // batches} U-Net calls)")
    for kernel, n in expect.items():
        if launches[kernel] != n:
            raise AssertionError(f"{name}: {kernel} launched "
                                 f"{launches[kernel]} times on the served "
                                 f"path, expected {n}")


def report_busy(name, busy):
    if busy is None:
        log(f"{name} served batch device-busy share: not measured (the "
            "profiler trace holds no device time)")
    else:
        log(f"{name} served batch device-busy share (profiler trace): device "
            f"{busy['device_s']:.4f} s / wall {busy['wall_s']:.4f} s = "
            f"{busy['share']:.3f}; the same batch untraced took "
            f"{busy['untraced_wall_s']:.4f} s")


def serving_phase(torch, counters):
    """The flagship BASE bundle served over HTTP (DDIM-50). Returns the
    launches, a report, and its 16-image request's images (the SR phase's
    low-resolution inputs)."""
    from sdm_tpu_torch.serving import SamplerEngine
    with tempfile.TemporaryDirectory() as tmp:
        cfg = _export(torch, tmp, "flagship", FLAGSHIP, IMG, "BASE")
        engine = SamplerEngine(cfg, diff_alg="ddim", step_size=DDIM_STEP,
                               max_batch=BATCH, dtype="bfloat16", log=log)
        requests = [dict(num_images=BATCH, seed=1, format="npy"),
                    dict(num_images=3, seed=2, format="npy"),
                    dict(num_images=5, seed=3, format="npy"),
                    dict(num_images=3, seed=2, format="npy")]
        images, launches, stats, t_big = serve_requests(
            torch, engine, counters, requests)
        busy = traced_batch(torch, engine, [dict(num_images=BATCH, seed=4)])
    check_served("flagship", images, requests, IMG, launches, stats,
                 FLAGSHIP, streaming=0)
    log(f"flagship served: 16-image request {t_big:.3f} s -> "
        f"{BATCH / t_big:.3f} img/s; engine stats {stats} -> device_seconds "
        f"per batch {stats['device_seconds'] / stats['batches']:.3f}")
    report_busy("flagship", busy)
    return launches, dict(img_per_s_16=BATCH / t_big,
                          request_16_seconds=t_big, stats=stats,
                          traced_batch=busy), images[0]


def sr_serving_phase(torch, counters, lr_images):
    """The cascade's second stage: an SR bundle (cond_t 250, cold sampling
    with step 20) served over HTTP with the flagship's images as the
    low-resolution inputs, sent as raw float32 (lr_image_b64 + lr_shape)."""
    import numpy as np
    from sdm_tpu_torch.ops.resize import area_resize
    from sdm_tpu_torch.serving import SamplerEngine

    def lr_request(i, n, seed):
        lr = np.ascontiguousarray(lr_images[i], np.float32)
        return dict(num_images=n, seed=seed, format="npy",
                    lr_image_b64=base64.b64encode(lr.tobytes()).decode(),
                    lr_shape=list(lr.shape))

    with tempfile.TemporaryDirectory() as tmp:
        cfg = _export(torch, tmp, "sr", SR, SR_IMG, "SR", cond_t=SR_COND_T)
        engine = SamplerEngine(cfg, step_size=DDIM_STEP, max_batch=BATCH,
                               dtype="bfloat16", log=log)
        if engine.kind != "sr":
            raise AssertionError(f"SR bundle served as {engine.kind}")
        requests = [lr_request(0, BATCH, 1), lr_request(1, 3, 2),
                    lr_request(2, 5, 3), lr_request(1, 3, 2)]
        images, launches, stats, t_big = serve_requests(
            torch, engine, counters, requests)
        # Every flagship image once: sixteen one-image requests, one batch.
        busy = traced_batch(torch, engine, [
            dict(num_images=1, seed=10 + i, lr_image=lr_images[i])
            for i in range(BATCH)])
    check_served("sr", images, requests, SR_IMG, launches, stats, SR,
                 streaming=1)
    # The model's delta is a tanh output: every image lies within 1 of its
    # upsampled LR input.
    for i, (arr, lr_i) in enumerate(zip(images, (0, 1, 2, 1))):
        up = area_resize(torch.tensor(np.asarray(lr_images[lr_i],
                                                 np.float32))[None],
                         SR_IMG, SR_IMG).numpy()
        dev = float(np.abs(arr - up).max())
        if dev > 1.0 + 1e-3:
            raise AssertionError(f"sr request {i}: |image - upsampled| "
                                 f"reaches {dev}, past the delta's tanh range")
    log(f"sr served: each image within 1 of its upsampled LR input; 16-image "
        f"request {t_big:.3f} s -> {BATCH / t_big:.3f} img/s; engine stats "
        f"{stats} -> device_seconds per batch "
        f"{stats['device_seconds'] / stats['batches']:.3f}")
    report_busy("sr", busy)
    return launches, dict(img_per_s_16=BATCH / t_big,
                          request_16_seconds=t_big, stats=stats,
                          traced_batch=busy)


def traced_batch(torch, engine, requests):
    """Device-busy share of one served batch: the device time in a
    torch.profiler (CUPTI) trace of engine.generate_batch over the batch's
    wall time. The untraced wall time of the same batch is kept beside it,
    since tracing slows the host. None when the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t0 = time.monotonic()
    engine.generate_batch(requests)
    untraced = time.monotonic() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        engine.generate_batch(requests)
        wall = time.monotonic() - t0
    device = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA) / 1e6
    if device <= 0:
        return None
    return dict(device_s=device, wall_s=wall, share=device / wall,
                untraced_wall_s=untraced)


def summarize(results, launches):
    """One entry per kernel: the main path's shapes (bf16, query axis),
    times summed over one U-Net call: the flagship's for the kernels of
    slice 1, the SR model's for the streaming kernels. `launches` sums the
    two served paths; `launches_by_path` keeps them apart."""
    meta = {
        "fused_adagn": ("adagn", "flagship", "sdm_tpu_torch/csrc/adagn.cu",
                        "sdm_tpu/kernels/adagn.py:115", ADAGN_PER_CALL),
        "fused_attention": ("attention", "flagship",
                            "sdm_tpu_torch/csrc/attention.cu",
                            "sdm_tpu/kernels/attention.py:86", 1),
        "fused_attention_block": ("attention_block", "flagship",
                                  "sdm_tpu_torch/csrc/linear.cu",
                                  "sdm_tpu/kernels/attention_block.py:88",
                                  1),
        "streaming_stats": ("streaming_stats", "sr",
                            "sdm_tpu_torch/csrc/streaming_attention.cu",
                            "sdm_tpu/kernels/streaming_attention.py:223", 1),
        "streaming_apply": ("streaming_apply", "sr",
                            "sdm_tpu_torch/csrc/streaming_attention.cu",
                            "sdm_tpu/kernels/streaming_attention.py:234", 1),
    }
    # STREAM_SHAPES[0] is the SR model's one streaming block.
    shapes = {"flagship": None, "sr": [[BATCH, *STREAM_SHAPES[0]]]}
    out = []
    for name, (kernel, model, source, replaces, per_call) in meta.items():
        rows = [r for r in results if r["kernel"] == kernel
                and r["model"] == model and r["dtype"] == "bfloat16"
                and r.get("axis", "q") == "q"
                and (shapes[model] is None or r["shape"] in shapes[model])]
        lib = [r["library_ms"] for r in rows]
        out.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(path[name] for path in launches.values()),
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=sum(r["ms"] for r in rows) * per_call,
            plain_ms=sum(r["plain_ms"] for r in rows) * per_call,
            bound_ms=sum(r["bound_ms"] for r in rows) * per_call,
            bound_by=max(rows, key=lambda r: r["bound_ms"])["bound_by"],
            library_ms=(None if any(v is None for v in lib)
                        else sum(lib) * per_call),
            launches_by_path={path: n[name] for path, n in launches.items()},
            per=f"one {model} U-Net call, batch 16, bf16, query axis"))
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from sdm_tpu_torch.kernels import _build
        from sdm_tpu_torch.kernels.adagn import fused_adagn
        from sdm_tpu_torch.kernels.attention import fused_attention
        from sdm_tpu_torch.kernels.attention_block import (
            fused_attention_block, linear)
        from sdm_tpu_torch.kernels.streaming_attention import (
            streaming_apply, streaming_stats)
    except ImportError as e:
        print(f"chip_smoke: the sdm_tpu_torch package is missing ({e}); run "
              "from the repository root", file=sys.stderr)
        return 2

    t_start = time.monotonic()
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.monotonic()
    _build.build()
    log(f"build: {time.monotonic() - t0:.1f} s for {list(_build.SOURCES)}")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    results = []
    t0 = time.monotonic()
    kernel_phase(torch, results)
    log(f"kernel phase: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    model = {"flagship": model_phase(torch, "flagship", FLAGSHIP, IMG),
             "sr": model_phase(torch, "sr", SR, SR_IMG)}
    log(f"model phase: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    counters = [fused_adagn, fused_attention, fused_attention_block, linear,
                streaming_stats, streaming_apply]
    launches, served = {}, {}
    launches["flagship"], served["flagship"], lr_images = serving_phase(
        torch, counters)
    launches["sr"], served["sr"] = sr_serving_phase(torch, counters,
                                                    lr_images)
    log(f"serving phase: {time.monotonic() - t0:.1f} s")

    kernels = summarize(results, launches)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, torch=torch.__version__,
                       results=results, kernels=kernels, model=model,
                       served=served,
                       seconds=time.monotonic() - t_start), f, indent=1)
    log(f"total {time.monotonic() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
