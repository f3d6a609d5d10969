#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (sdm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --phases build,streaming

Phases, each raising on failure (the script exits non-zero on any). With
no arguments every phase runs; `--phases` runs only the named ones of
build, kernels, streaming, model, serving, generation, training,
extensions, remat, loop, distill, eval, parallel, model_parallel,
tooling (the build always),
logs which it skipped, prints no `kernels` line and ends with
{"ok": true, "partial": true, ...}. It needs one card; on a machine with
more, the trainers and the distiller stay on card 0 (num_devices=1),
while the generators take replicas on as many cards as divide the batch,
as a user's run would.

  1. Device and build ("build"): the card's name and power limit
     (nvidia-smi), TF32 off for the fp32 comparisons, and every kernel
     built from sdm_tpu_torch/csrc (one nvcc per source, all at once);
     ptxas's registers and spills of every kernel logged, and every
     instantiation of the tensor-core kernels (the TMA + wgmma
     stream_stats_wgmma, stream_apply_wgmma (the forward's apply and dV)
     and stream_da_wgmma (dK, dQ) of the streaming attention;
     the TMA + wgmma attn_stats_wgmma, attn_apply_wgmma of the whole-S
     attention and linear_wgmma) and AdaGN's one-pass adagn_grid held to 0
     spill bytes, and the streaming library's wgmma instantiations to no
     ptxas line on serialized wgmma.
  2. Kernels vs plain ("kernels": AdaGN, attention, block; "streaming":
     the streaming kernels): each hand-written kernel held against its plain
     PyTorch version at every shape the flagship 128x128 U-Net and the
     256x256 super-resolution (SR) U-Net give it, batch 16, fp32 and bf16,
     both softmax axes (each attention and stats check also against the
     wrong axis, which must fail); kernel, plain and library times and the
     least time the card could take (bound). The whole-S attention and the
     stats kernel also run at D = 128, 384 and 768 and S = 64
     (EXTRA_SHAPES), and the attention at four heads on strided views.
     `linear` is held against its plain version at each block's two
     projections (with and without the residual epilogue), at a ragged
     M x N, an odd N, a K tail and a row stride its tensor-core admission
     refuses, each launch on the wgmma kernel exactly when the admission
     says so, and timed (with its TFLOP/s) against F.linear (cuBLAS).
     AdaGN: bf16 on its one-pass kernel (adagn_grid), fp32 on the two-pass
     kernels, each call's route counter held to its plan
     (`one_pass_launches`, `two_pass_launches`), timed back to back
     beside F.group_norm + FiLM, bf16 also queued behind a sleep kernel
     (device time alone); also with per-sample FiLM rows, at an input mean
     of 50, bf16 at batch 2 (fewer rows than SMs), two runs for identical
     bits, and its Python plan held to the C one (sdm_adagn_plan) at every
     shape and batch 1, 2, 3, 8, 16, 32. The
     streaming kernels, forward (stats, apply) and
     backward (dV, dK, dQ), run at the SR model's S = 4096, at S = 1024,
     where the whole-S kernel is a second reference, and at a ragged
     S = 300; the bf16 query-axis dK and dQ are also held to a float64
     truth (BWD_TRUTH), and the fp32-output apply to its plain version.
     Each stats, apply, dV, dK and dQ launch must take the TMA + wgmma
     kernels (stream_stats_wgmma, stream_apply_wgmma, whose dv_pass
     instantiations dV runs with q and k swapped, stream_da_wgmma) exactly
     when their admission says so (the `wgmma_launches` counters); the
     admissions, plans, ring stages and shared memory of the wgmma kernels
     are held to the C exports.
     Small shapes off the main path (S = 300, D = 128, 256, 384, 1024) run
     the whole streaming function and each backward pass and check which
     kernel each launch took (the `mma_launches` and `wgmma_launches`
     counters), and the Python mirrors
     of the C admissions, plans and shared-memory formulas are held to the
     C functions.
  3. Model ("model"): the flagship and the SR U-Net from seeded random
     weights, use_kernels=True against use_kernels=False, one call at batch
     16 (t=500), fp32 and bf16, and a profiler breakdown of one bf16 call
     each (its trace holding one AdaGN kernel a fused_adagn call). Then one forward and backward of each under the training loss,
     kernels against plain, gradients held per tensor (fp32) and as a whole
     (bf16).
  4. Serving ("serving"), the cascade: the flagship exported as a BASE
     bundle and served over HTTP by DiffusionServer over SamplerEngine(ddim,
     step 20 = DDIM-50, batch 16, bf16); a 16-image request and two small
     requests that coalesce. Its 16 images then become the low-resolution
     inputs of an SR bundle (seeded random weights, cond_t 250) served the
     same way (cold sampling, step 20: 51 U-Net calls, bf16, batch 16), the
     images sent as raw floats (lr_image_b64 + lr_shape). Around each path's
     requests the kernels' launch counters are zeroed just before and read
     just after, and held to the counts its U-Net calls imply, every bf16
     whole-S attention, every `linear` and every streaming stats and
     streaming apply on the wgmma kernels (`mma_launches`, and the
     streaming passes' `wgmma_launches`). Then one more batch of each is
     traced with the profiler for the device's busy share.
  5. Generation ("generation"): the DDIM/DDPM generator
     (generate_images_diffusion) on an exported flagship bundle, DDIM step
     20, bf16, 16 images, its images held normwise to the serving engine's
     for the same injected noise; then a two-entry ensemble of the same
     weights (steps 501-1000, then 1-500) and a doodle bundle (6 input
     channels) with a conditioning image. Around each generator run the
     launch counters are zeroed and read, and held to the counts its U-Net
     calls imply; its img/s is logged.
  6. Training ("training"): the SR trainer (run_training(SR_SPEC), the SR
     U-Net at full width, 256x256, batch 16, bf16), then the base eps, the
     cold and the doodle trainers (the flagship, 128x128; the cold U-Net
     with its tanh out, the doodle U-Net with 6 input channels reading
     image/doodle pairs from a TinyDB file) for TRAIN_STEPS steps each on
     seeded uint8 images, kernels on. Each run checkpoints (with a
     preview, and the doodle trainer's label_plot grid) at step 0 only and
     once more when it stops. The launch counters are zeroed just before
     each run and read just after, and held to the counts its steps and
     its preview imply (every whole-S attention, every `linear` and every
     streaming stats, apply, dV, dK and dQ on the wgmma kernels); the
     losses must
     be finite, the step-0 checkpoint must reload strictly into a fresh
     model and Adam, moments included, and one more step of each trainer
     is profiled by kernel family.
  7. Extensions ("extensions"): the sampler and training extensions at
     full width and depth, bf16, batch 16, on the flagship and on the
     label-conditional flagship (COND: 10 labels). Served by the engine:
     DDIM-50 as this run's baseline, dpmpp and heun with Karras spacing (its step-20 list: one and two
     U-Net calls per step), and the conditional bundle with guidance 3.0
     (DDIM-50, each call at batch 32); one guided U-Net call (the doubled
     batch of 32) held kernels on against off, and its guided combine; one
     forward and backward of COND at the trainer's micro-batch of 8 (one t
     per sample, one-hot labels) held kernels on against off. Generated: img2img from step 500 (26 calls), inpainting
     with the left half kept (51), a v-bundle ("objective": "V") with
     dpmpp (51), and the flagship at --dtype float32, which must launch no
     kernel and give the plain U-Net's images. Trained: the base trainer
     on the conditional flagship with V, ema_decay, min_snr_gamma,
     cfg_drop_prob and grad_accum_steps 2 (EXT_TRAIN), as phase 6 checks
     a trainer, plus the "ema" weights of both checkpoints reloaded
     strictly. Every run's launches are held to its U-Net calls, every
     whole-S attention and every `linear` on wgmma.
  8. Remat ("remat"): the SR U-Net (bf16, batch 16, kernels on) with
     config "remat" against without, one forward and backward each: the
     loss equal, the whole gradient within GRAD_TOL, the launches of each
     held (under remat every forward kernel runs three times: the
     backward replays each block, then each nested sublayer), the peak
     device memory of each, and of the remat step at batch 64.
  9. Loop ("loop"): the base trainer on the flagship with
     "device_dataset" (steps_per_call 4, 8 steps: the resident data's
     line, step-cadence checkpoints at the chunk boundaries, launches
     held), then 24 steps fused and 24 per step for the median step
     interval and launches per step of each; then "async_checkpoint", the
     saved parameters and Adam moments at steps 2 and 4 held bit for bit
     to synchronous clones taken right after those steps.
 10. Distillation ("distill"): one step of progressive distillation on the
     flagship (bf16, batch 16) kernels on against off, injected rows and
     eps (the loss and the student's gradients within GRAD_TOL; 3 U-Net
     forwards of launches), its device time and median; then
     cli/distill_diffusion.py for 2 phases of DISTILL_STEPS steps from a
     saved teacher, per-step and device-resident data, launches held, both
     students reloaded strictly, the last exported and sampled at its own
     step size.
 11. Eval ("eval"): randconv and pixel features of 64 images on the card
     against the CPU (FEATURE_TOL), their extraction time; FID and KID of
     the set against itself (0) and a dimmed copy; then
     cli/evaluate_samples.py --gen-config on the exported flagship (bf16,
     DDIM-50, 16 images), launches held.

 12. Parallel ("parallel"): (a) a one-rank NCCL group, then the flagship
     base trainer through run_training (so under DistributedDataParallel,
     the real reducer) for TRAIN_STEPS steps, its losses and final
     parameters held to the same seeded run without a group (1e-6
     normwise; bit-equality logged), its launches to the per-step
     trainer's, its median step beside the plain one's; (b) one SR train
     step (256x256, batch 16, bf16) under FSDP2 (fully_shard) at one rank
     against the unwrapped U-Net: gradients within GRAD_TOL, the streaming
     dV, dK and dQ once each, step ms, peak memory and state bytes per
     device of both; (c) the two-entry flagship ensemble generated with
     --pipeline 2 against the sequential ensemble (normwise, MODEL_TOL's
     bf16 limit; bit-equality logged), launches held (the pipeline's are
     twice the sequential run's: each microbatch of 8 runs every stage's
     sampler); (d) with two or more
     cards, a two-rank --num-devices 2 base run and the engine at
     num_devices=2 against one card; with one card a line says they were
     skipped.
 13. Model parallelism ("model_parallel"): (a) in a one-rank NCCL group,
     the flagship's base train step and the SR model's train step (256x256:
     the streaming stats, apply, dV, dK and dQ kernels), batch 16, bf16,
     kernels on, with every conv and linear column-parallel
     (parallel/tp.py, tp_min_width 1) against the unwrapped U-Net: the loss
     within MODEL_TOL, the whole gradient within GRAD_TOL, the same
     launches as unwrapped (the phase's launches), the step's ms and peak
     memory beside the unwrapped one's; (b) one SR train step (256x256,
     batch 16, bf16, kernels off) inside the SP context (parallel/sp.py)
     at one rank against the plain U-Net: gradients within GRAD_TOL, no
     launch, peak memory of both; (c) with two or more cards,
     run_training(BASE_SPEC) with "tp": 2 and with "sp": 2 (four cards:
     also tp2 x sp2 and dp2 x tp2) for TRAIN_STEPS steps, each logged loss
     within MODEL_TOL of the one-card run's; on two cards, the whole
     gradients of one SR step at sp=2 and of one flagship step at tp=2
     against the same seeded batch on one card (GRAD_TOL), and the
     U-Net's output on a seeded probe, row by row (MODEL_TOL); the sp=2
     step's peak per card beside (b)'s; the collective bytes
     (parallel/analysis.py) and ms of a two-card DP and TP flagship step;
     the SR trainer and the fused base trainer ("device_dataset") at tp=2,
     their losses against one card's, the SR run's streaming launches per
     rank held; the SR generator with --sp 2 on one image against one card
     (its residual, image minus upsampled, normwise within MODEL_TOL). On
     four cards also the base trainer with "fsdp" at dp2 x tp2, dp2 x sp2
     and tp2 x sp2 against one card, and the tp2 x sp2 + fsdp run resumed
     from its gathered checkpoint against the one-card resume. With one
     card a line says (c) was skipped.
 14. Tooling ("tooling"): the base trainer with "profile_trace_dir" (its
     trace names the port's kernels: adagn_*, attn_stats_wgmma,
     attn_apply_wgmma, linear_wgmma; launches held); a run with
     "native_checkpoint" resumed from its native directory, bit for bit
     equal to the .pt + config resume; the loader's decode path, native
     batches bit for bit equal to the per-image cv2 ones (or one line
     saying what this machine lacks).

Prints a `kernels` JSON line, then as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Per-shape results also go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import base64
import json
import math
import os
import re
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
# The whole-S (S, C) blocks of either U-Net whose apply carries the output
# projection (kernels/attention_block.py::block_route 2: bf16, d_k = C =
# 512, S >= BFUSED_MIN_S): three launches a block, no r tensor.
FUSED_OUT_SHAPES = [(1024, 512)]
DDIM_STEP = 20
# The SR model (bench.py sr_net): 256x256 output from 6 input channels (the
# noisy image and the q-sampled upsampled LR image), tanh out; otherwise
# the flagship's widths. Served with cold sampling, step 20 (51 calls).
SR_IMG = 256
SR = dict(FLAGSHIP, in_channel=6, image_recon=True)
SR_COND_T = 250
# The cold trainer's U-Net (the flagship with its tanh out, as the wizard's
# cold configs set img_recon) and the doodle U-Net (the flagship taking x_t
# and the 3-channel conditioning image): only the tanh and the first conv
# differ, so every kernel shape is the flagship's.
COLD = dict(FLAGSHIP, image_recon=True)
DOODLE = dict(FLAGSHIP, in_channel=6)
# The generator's two-entry ensemble: the same weights over these ranges.
ENSEMBLE = ((501, 1000), (1, 500))
# The extensions phase: the label-conditional flagship (10 labels, the
# flagship otherwise) served with classifier-free guidance at this scale
# and trained with the step's extensions (EXT_TRAIN: V, EMA, min-SNR, CFG
# label dropout, grad accumulation 2, so each step runs two batches of 8);
# img2img from INIT_STEP (26 DDIM calls).
COND = dict(FLAGSHIP, cond_dim=10)
GUIDANCE_SCALE = 3.0
INIT_STEP = 500
EXT_TRAIN = dict(objective="V", ema_decay=0.999, min_snr_gamma=5.0,
                 cfg_drop_prob=0.1, grad_accum_steps=2)
SR_ADAGN_SHAPES = [(256, 256, 128), (128, 128, 256), (64, 64, 512),
                   (32, 32, 512), (16, 16, 1024), (32, 32, 1024),
                   (64, 64, 1024), (128, 128, 512)]
# (S, C) of the SR model's attention blocks: down layers 2 and 3, up layers
# 3 and 2. S = 4096 is past the whole-S kernel's shared memory and streams.
SR_BLOCK_SHAPES = [(4096, 512), (1024, 512), (256, 1024), (1024, 1024)]
# Streaming attention checks, (S, D): the SR shape, and one the whole-S
# kernel also takes.
STREAM_SHAPES = [(4096, 512), (1024, 512)]
# Whole-S attention and stats checks off the U-Nets' shapes: D = 128 (64
# columns a P V warp), 384, 768 (the wide apply in two splits of 384
# columns) and S = 64 (one key tile of the stats ring, half of it live).
EXTRA_SHAPES = [(256, 128), (256, 384), (1024, 768), (64, 128)]
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
# The guided combine u + s (c - u) of kernels-on against kernels-off
# branches: each branch's error within MODEL_TOL, scaled by |s| and |1 - s|.
COMBINE_TOL = ((abs(GUIDANCE_SCALE) + abs(1.0 - GUIDANCE_SCALE))
               * MODEL_TOL["bfloat16"])
# Streaming backward kernels vs their plain versions. fp32: both sum fp32
# products in another order, and dA = P (g v^T - corr) cancels, so an
# element's error is set by the gradient's scale (of_max) more than by the
# element. bf16 (dV on both axes, dK and dQ on the key axis): a one-ulp flip
# of a bf16 P or dA entry, scaled by the output's size.
BWD_TOL = {"float32": dict(atol=0.0, rtol=1e-3, of_max=1e-3),
           "bfloat16": dict(atol=0.0, rtol=2e-2, of_max=2e-2)}
# bf16 dK and dQ on the query axis are cancellation-dominated (the softmax
# Jacobian projects out nearly all of g; BASELINE.md "On-TPU kernel
# numerics"), so any bf16 backward carries noise comparable to the value.
# There the kernel and the plain version are both held to a float64 truth
# on the same bf16 inputs, error = max|x - truth| / max|truth|: the kernel's
# may be at most `mult` times the plain version's plus `add`. Against the
# plain version the bound is then (kernel limit + plain error) * max|truth|.
BWD_TRUTH = {"mult": 2.0, "add": 1e-3}
TRUTH_ROWS = 2      # batch rows of the float64 truth (dense S x S each)
# U-Net gradients, kernels on vs off, after one forward and backward under
# the training loss. fp32, per parameter tensor: |g_k - g_p| over
# max(|g_p|, GRAD_FLOOR * the largest |g_p| of the model). The forward
# agrees to about 2e-7; the query-axis softmax Jacobian cancels all but
# about 1/400 of g (|dQ| against |dV|), which can take dQ's and dK's
# relative error to about 1e-4; a gradient the kernels drop gives 1. The
# floor: a conv bias ahead of a GroupNorm has a true gradient near zero
# (the norm removes its per-group mean), so its own norm is noise. bf16, the
# whole gradient at once: every product rounds to 2^-8, the forward already
# differs by about 2e-3 normwise and the backward amplifies that through
# the same cancellation, so a per-tensor bound would be set by noise.
GRAD_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
GRAD_FLOOR = 1e-3
# Trainers: steps per run (the first, which checkpoints and previews, is
# left out of the rate), and the seeded images of the dataset (one epoch).
TRAIN_STEPS = 6
TRAIN_IMAGES = TRAIN_STEPS * BATCH


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


def time_queued_ms(fn, reps: int) -> float:
    """Mean device ms of fn over `reps` launches queued behind a sleep
    kernel: the host enqueues every launch before the first runs, so its
    own time per call (a wrapper's checks, allocation and launch) drops
    out, which `time_ms` reads where it exceeds the kernel's."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)   # tens of ms of device time
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

def seeded_randn(torch, seed):
    """(device, randn) with randn(shape, dtype, std, mean) drawing from one
    generator on the card seeded with `seed`."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(shape, dtype, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * std
                + mean).to(dtype)
    return dev, randn


ROUTES = ("two passes", "one pass")


def check_adagn_plans(torch):
    """The Python mirror of AdaGN's plan (kernels/adagn.py::adagn_plan)
    against the C one (sdm_adagn_plan) on this card's SMs: every (H, W, C)
    of both U-Nets at batch 1 and 2 (a small engine, a data-parallel
    share), 3 (a served remainder), 8, 16 and 32, in fp32 and bf16."""
    import ctypes
    from sdm_tpu_torch.kernels import _build
    from sdm_tpu_torch.kernels import adagn as ag
    lib = _build.library("adagn", ag._SIGNATURES)
    sms = ag.sm_count(torch.device("cuda"))
    routes = {}
    for h, w, c in ADAGN_SHAPES + [sh for sh in SR_ADAGN_SHAPES
                                   if sh not in ADAGN_SHAPES]:
        for n in (1, 2, 3, 8, 16, 32):
            for dtype in (torch.float32, torch.bfloat16):
                code = _build.DTYPE_CODES[dtype]
                got = (ctypes.c_int * 6)()
                lib.sdm_adagn_plan(n, h * w, c, GROUPS, code, code, sms, got)
                want = ag.adagn_plan(n, h * w, c, GROUPS, dtype, dtype, sms)
                if tuple(got) != tuple(want):
                    raise AssertionError(
                        f"adagn plan {n}x{h}x{w}x{c} {dtype}: C {tuple(got)}"
                        f" != Python {tuple(want)}")
                if dtype == torch.bfloat16 and want.route != ag.ONE_PASS:
                    raise AssertionError(
                        f"adagn plan {n}x{h}x{w}x{c} bf16: two passes")
                if n == BATCH and dtype == torch.bfloat16:
                    routes[f"{h}x{w}x{c}"] = ROUTES[want.route]
    log(f"adagn plans: the Python mirror equals sdm_adagn_plan at 14 shapes "
        f"x batch 1/2/3/8/16/32 x fp32/bf16 ({sms} SMs), every bf16 plan one "
        f"pass; bf16 at batch {BATCH}: "
        + ", ".join(f"{k} {v}" for k, v in routes.items()))


def adagn_checks(torch, randn, results, dtype):
    """AdaGN against its plain version at every shape of both U-Nets in
    `dtype`, each call on the route its plan gives (bf16: the one-pass
    kernel, counted in `one_pass_launches`; fp32: the two passes), timed
    back to back beside plain and F.group_norm + FiLM, and (bf16, the main
    path) queued (device time alone); then per-sample FiLM rows, an input
    mean of 50, and (bf16) batch 2 at 8x8x1024 (64 blocks, a row each) and
    two runs of the smallest and the largest shape for identical bits."""
    import torch.nn.functional as F
    from sdm_tpu_torch.kernels import adagn as ag
    from sdm_tpu_torch.kernels.adagn import adagn_reference, fused_adagn
    dn = str(dtype).split(".")[-1]
    isz = torch.tensor([], dtype=dtype).element_size()
    sms = ag.sm_count(torch.device("cuda"))
    adagn = [("flagship", sh) for sh in ADAGN_SHAPES] + [
        ("sr", sh) for sh in SR_ADAGN_SHAPES if sh not in ADAGN_SHAPES]

    def inputs(h, w, c, film_rows=1, mean=0.5, n=BATCH):
        return (randn((n, h, w, c), dtype, std=2.0 if mean < 10 else 1.0,
                      mean=mean),
                randn((c,), dtype, std=0.1, mean=1.0),
                randn((c,), dtype, std=0.1),
                randn((film_rows, c), dtype, std=0.5, mean=1.0),
                randn((film_rows, c), dtype, std=0.5), GROUPS)

    def checked(tag, args):
        """One call against plain, its route's counter moved once."""
        n, h, w, c = args[0].shape
        plan = ag.adagn_plan(n, h * w, c, GROUPS, dtype, dtype, sms)
        if dtype == torch.bfloat16 and plan.route == ag.TWO_PASS:
            raise AssertionError(f"adagn {tag}: bf16 main-path shape off "
                                 "the one-pass kernel")
        before = (fused_adagn.one_pass_launches,
                  fused_adagn.two_pass_launches)
        got = fused_adagn(*args)
        moved = (fused_adagn.one_pass_launches - before[0],
                 fused_adagn.two_pass_launches - before[1])
        if moved != ((0, 1) if plan.route == ag.TWO_PASS else (1, 0)):
            raise AssertionError(f"adagn {tag}: {ROUTES[plan.route]} plan "
                                 f"but one-pass, two-pass launches {moved}")
        return got, compare(f"adagn {tag}", got, adagn_reference(*args),
                            TOL[dn]), plan

    for model, (h, w, c) in adagn:
        args = inputs(h, w, c)
        x, gamma, beta, s, t = args[:5]
        _, err, plan = checked(f"{dn} {h}x{w}x{c}", args)
        reps = 20
        ms = time_ms(lambda: fused_adagn(*args), reps)
        plain = time_ms(lambda: adagn_reference(*args), reps)
        xc = x.permute(0, 3, 1, 2)          # NCHW channels_last view
        s4, t4 = s[:, :, None, None], t[:, :, None, None]

        def library():
            return F.group_norm(xc, GROUPS, gamma, beta) * s4 + t4
        lib = time_ms(library, reps)
        # Device time alone on the main path (bf16); fp32 back to back only.
        queued = lib_queued = None
        if dtype == torch.bfloat16:
            queued = time_queued_ms(lambda: fused_adagn(*args), reps)
            lib_queued = time_queued_ms(library, reps)
        nbytes = BATCH * h * w * c * 2 * isz + 4 * c * isz
        ops = BATCH * h * w * c * 8.0
        b, by = bound_ms(nbytes, ops, "float32")
        results.append(dict(kernel="adagn", model=model, dtype=dn,
                            shape=[BATCH, h, w, c], route=ROUTES[plan.route],
                            plan=list(plan), max_abs_err=err[0],
                            max_rel_err=err[1], tol=TOL[dn], ms=ms,
                            queued_ms=queued, plain_ms=plain, library_ms=lib,
                            library_queued_ms=lib_queued, bound_ms=b,
                            bound_by=by))
        q_text = "" if queued is None else f" (queued {queued:.4f})"
        lq_text = "" if lib_queued is None else f" (queued {lib_queued:.4f})"
        log(f"adagn {dn:8s} {h:3d}x{w:3d}x{c:4d} {ROUTES[plan.route]:10s} "
            f"{err_text(err, TOL[dn])}  kernel {ms:.4f} ms{q_text}  plain "
            f"{plain:.4f}  group_norm+FiLM {lib:.4f}{lq_text}  bound {b:.4f} "
            f"({by})")
        del x, xc, args
    # Training gives each sample its own t, so the FiLM tables have one row
    # per sample. A large mean (50, std 1): E[x^2] - mean^2 would cancel to
    # noise here; the merged Welford/Chan statistics must not. C = 384
    # gives groups of 12 channels, which straddle the 8-channel vectors;
    # 256x256x128 is the SR model's largest layer. Batch 2 (a small
    # engine's, or a data-parallel share of max_batch 8 over 4 cards) at
    # 8x8x1024: 128 rows over 132 SMs, so the one pass runs 64 blocks a
    # sample, a row each.
    for check, (h, w, c), rows, mean, n in (
            ("per-sample FiLM", SR_ADAGN_SHAPES[2], BATCH, 0.5, BATCH),
            ("per-sample FiLM", SR_ADAGN_SHAPES[3], BATCH, 0.5, BATCH),
            ("mean 50, std 1", ADAGN_SHAPES[-1], 1, 50.0, BATCH),
            ("mean 50, std 1", SR_ADAGN_SHAPES[0], 1, 50.0, BATCH),
            ("batch 2", ADAGN_SHAPES[4], 1, 0.5, 2)):
        _, err, plan = checked(f"{dn} {n}x{h}x{w}x{c} {check}",
                               inputs(h, w, c, rows, mean, n))
        results.append(dict(kernel="adagn_check", check=check, dtype=dn,
                            shape=[n, h, w, c], route=ROUTES[plan.route],
                            plan=list(plan), max_abs_err=err[0],
                            max_rel_err=err[1]))
        log(f"adagn {dn:8s} {n:2d}x{h:3d}x{w:3d}x{c:4d} "
            f"{ROUTES[plan.route]:10s} {check}  {err_text(err, TOL[dn])}")
    if dtype == torch.bfloat16:
        # Fixed merge orders, no float atomics: the same bits twice.
        for h, w, c in (ADAGN_SHAPES[4], SR_ADAGN_SHAPES[0]):
            args = inputs(h, w, c)
            first = fused_adagn(*args)
            same = torch.equal(first, fused_adagn(*args))
            results.append(dict(kernel="adagn_check", check="two runs "
                                "identical", dtype=dn, shape=[BATCH, h, w, c],
                                identical=same))
            log(f"adagn {dn:8s} {h:3d}x{w:3d}x{c:4d} two runs identical: "
                f"{same}")
            if not same:
                raise AssertionError(f"adagn {h}x{w}x{c}: two runs differ")
            del first, args


def kernel_phase(torch, results):
    """AdaGN, the whole-S attention and the block (phase 2, without the
    streaming kernels)."""
    from sdm_tpu_torch.kernels.attention import (attention_reference,
                                                 fused_attention)
    from sdm_tpu_torch.kernels.attention_block import (
        attention_block_reference, fused_attention_block)

    dev, randn = seeded_randn(torch, 0)
    check_adagn_plans(torch)

    for dtype in (torch.float32, torch.bfloat16):
        adagn_checks(torch, randn, results, dtype)
        cases = [("flagship", sh) for sh in BLOCK_SHAPES] + [
            ("sr", sh) for sh in SR_BLOCK_SHAPES if sh not in BLOCK_SHAPES]
        for model, (s_len, d) in cases:
            for axis in ("q", "k"):
                if s_len <= 1024:   # the whole-S kernel; S = 4096 streams
                    attention_case(torch, randn, results, model, dtype,
                                   s_len, d, axis)
                block_case(torch, randn, results, model, dtype, s_len, d,
                           axis)
        for s_len, d in EXTRA_SHAPES:
            for axis in ("q", "k"):
                attention_case(torch, randn, results, "extra", dtype, s_len,
                               d, axis)

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

    # Multi-head attention (heads > 1 goes to fused_attention itself):
    # q/k/v as strided views of one qkv buffer, as the layer passes them.
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        qkv = randn((BATCH, 256, 4, 3 * 128), dtype, std=QK_STD)
        q, k, v = qkv.split(128, dim=-1)
        for axis in ("q", "k"):
            mma0 = fused_attention.mma_launches
            got = fused_attention(q, k, v, 128 ** -0.5, axis)
            if fused_attention.mma_launches - mma0 != (dtype == torch.bfloat16):
                raise AssertionError(f"attention {dn} heads=4 {axis}: the "
                                     "bf16 strided views must take the "
                                     "TMA + wgmma kernels")
            want = attention_reference(q, k, v, 128 ** -0.5, axis)
            err = compare(f"attention {dn} heads=4 {axis}", got, want,
                          ATTN_TOL[dn])
            log(f"attention {dn:8s} S=256 H=4 D=128 {axis} (strided views)  "
                f"{err_text(err, ATTN_TOL[dn])}")

    check_attention_predicates(torch)
    check_block_routes(torch)
    linear_off_grid(torch, randn, results)
    # S beyond the longest the entry point takes is refused, launching
    # nothing: past the CUDA-core block's shared memory (fp32 S = 2048) and
    # past WHOLE_S_MAX_MMA on the tensor cores (bf16 S = 3264).
    for dtype, s_len in ((torch.float32, 2048), (torch.bfloat16, 3264)):
        long_seq = torch.zeros((1, s_len, 1, 128), device=dev, dtype=dtype)
        try:
            fused_attention(long_seq, long_seq, long_seq, 1.0, "q")
        except NotImplementedError as e:
            log(f"attention {dtype} S={s_len}: refused ({e})")
        else:
            raise AssertionError(f"attention: {dtype} S={s_len} was not "
                                 "refused")


def check_attention_predicates(torch):
    """The whole-S path's Python mirrors against csrc/attention.cu: `fits`
    against sdm_attention_fits (S = 64..8192, both paths), `admits_wgmma`
    against sdm_attention_takes_wgmma and `wgmma_plan` against
    sdm_attention_wgmma_plan over a grid of S, D, dtype, batch*heads and
    layouts (aligned, a pointer off by 8 bytes, a row stride off by 4
    elements, a head stride off by 2), and `wgmma_smem_bytes` and
    `wgmma_stages` against sdm_attention_wgmma_smem."""
    import ctypes
    from sdm_tpu_torch.kernels import _build
    from sdm_tpu_torch.kernels import attention as attn_mod
    lib = _build.library("attention", attn_mod._SIGNATURES)
    for s_len in range(64, 8193, 8):
        for tc in (0, 1):
            if bool(lib.sdm_attention_fits(s_len, tc)) != attn_mod.fits(
                    s_len, bool(tc)):
                raise AssertionError(f"whole_s_ok's mirror disagrees with "
                                     f"sdm_attention_fits at S={s_len}")
    checked = 0
    plan = (ctypes.c_int * 2)()
    smem = (ctypes.c_int * 4)()
    for d in range(8, 2561, 8):
        if d % 64 == 0 and d <= 1152:
            lib.sdm_attention_wgmma_smem(d, smem)
            mirror = (*attn_mod.wgmma_smem_bytes(d), *attn_mod.wgmma_stages(d))
            if tuple(smem) != mirror:
                raise AssertionError(f"wgmma_smem({d}) disagrees with C: "
                                     f"{list(smem)} vs {mirror}")
        for s_len in (64, 96, 256, 1024, 3200):
            for dt, dtype in ((0, torch.float32), (1, torch.bfloat16)):
                for ptr_off, ss_off, sh_off in ((0, 0, 0), (8, 0, 0),
                                                (0, 4, 0), (0, 0, 2)):
                    ptrs = [0x10000, 0x20000 + ptr_off, 0x30000, 0x40000]
                    strides = [(s_len * 3 * d, d + sh_off, 3 * d + ss_off)] * 3
                    strides.append((s_len * d, d, d))
                    cptrs = (ctypes.c_void_p * 4)(*ptrs)
                    cstr = (ctypes.c_longlong * 12)(*[x for st in strides
                                                      for x in st])
                    got = lib.sdm_attention_takes_wgmma(cptrs, cstr, s_len,
                                                        d, dt)
                    if bool(got) != attn_mod.admits_wgmma(dtype, s_len, d,
                                                          ptrs, strides):
                        raise AssertionError(
                            f"admits_wgmma disagrees with C at S={s_len} "
                            f"D={d} {dtype} pointer +{ptr_off} stride "
                            f"+{ss_off} head stride +{sh_off}")
                    checked += 1
            if d % 64 == 0 and d <= 1024 and s_len % 64 == 0:
                for bh in (1, 4, 16, 64):
                    lib.sdm_attention_wgmma_plan(bh, s_len, d, plan)
                    mirror = attn_mod.wgmma_plan(bh, s_len, d)
                    if tuple(plan) != mirror:
                        raise AssertionError(
                            f"wgmma_plan disagrees with C at bh={bh} "
                            f"S={s_len} D={d}: {list(plan)} vs {mirror}")
                    checked += 1
    log(f"whole-S admissions: the Python mirrors agree with the C functions "
        f"for S = 64..8192 (fits), D = 64..1152 (shared memory and ring "
        f"stages) and in {checked} admission and plan cases (D = 8..2560, "
        "S in 64, 96, 256, 1024, 3200, both dtypes, four layouts, "
        "batch*heads 1, 4, 16, 64)")


def streaming_phase(torch, results):
    """The streaming kernels, forward and backward (phase 2): every check at
    the SR shape and S = 1024, then shapes off the main path, then the
    Python mirrors of the C admissions."""
    _, randn = seeded_randn(torch, 1)
    for dtype in (torch.float32, torch.bfloat16):
        for (s_len, d) in STREAM_SHAPES:
            for axis in ("q", "k"):
                streaming_case(torch, randn, results, dtype, s_len, d, axis)
                streaming_bwd_case(torch, randn, results, dtype, s_len, d,
                                   axis)
                torch.cuda.empty_cache()
        # The stats kernel at the whole-S U-Net shapes (it is the whole-S
        # attention's first pass too) and off them; at (1024, 1024) also
        # on strided q and k views of one qkv buffer.
        shapes = [("flagship", sh) for sh in BLOCK_SHAPES] + [
            ("sr", sh) for sh in SR_BLOCK_SHAPES
            if sh not in BLOCK_SHAPES and sh not in STREAM_SHAPES] + [
            ("extra", sh) for sh in EXTRA_SHAPES]
        for model, (s_len, d) in shapes:
            for axis in ("q", "k"):
                stats_case(torch, randn, results, model, dtype, s_len, d,
                           axis, views=(s_len, d) == (1024, 1024))

    # Off the main path: a ragged S (CUDA-core kernels in bf16 too, ragged
    # tiles masked); D = 128 leaves each P V warp 64 columns (and each dA B
    # warpgroup one output chunk, in loads of two chunks); D = 256 gives dK
    # and dQ one load of four chunks a phase; D = 384 walks rows of 48
    # 16-byte chunks in the tile loader (and gives dA B three slots a
    # warpgroup); D = 1024 is past the wgmma dK and dQ and takes the CUDA
    # cores there in bf16 (its forward and dV stay on the wgmma kernels).
    for dtype in (torch.float32, torch.bfloat16):
        for axis in ("q", "k"):
            off_path_streaming_case(torch, randn, dtype, 300, 72, axis)
            streaming_bwd_case(torch, randn, results, dtype, 300, 72, axis)
            for d in (128, 256, 384, 1024):
                off_path_streaming_case(torch, randn, dtype, 256, d, axis)
    check_stream_predicates(torch)


def off_path_streaming_case(torch, randn, dtype, s_len, d, axis):
    """The whole streaming function, the fp32-output apply, dV, dK and dQ at
    a small shape (batch 2), each against its plain version (bf16 dK and dQ
    on the query axis through the float64 truth, as `streaming_bwd_case`),
    and the path each launch took against the Python mirror of the
    admission."""
    from sdm_tpu_torch.kernels import streaming_attention as sa
    dn = str(dtype).split(".")[-1]
    q, k, v, g = (randn((2, s_len, d), dtype, std=std)
                  for std in (QK_STD, QK_STD, 1.0, 1.0))
    scale = d ** -0.5
    tag = f"{dn} S={s_len} D={d} {axis}"
    mma0 = (sa.streaming_apply.mma_launches, sa.streaming_stats.mma_launches,
            sa.streaming_apply.wgmma_launches,
            sa.streaming_stats.wgmma_launches)
    bwd0 = bwd_mma_counts(sa)
    err = compare(f"streaming {tag}", sa.streaming_attention(q, k, v, scale,
                                                             axis),
                  sa.streaming_attention_reference(q, k, v, scale, axis),
                  ATTN_TOL[dn])
    m, l = sa.streaming_stats(q, k, scale, axis)
    out32 = sa.streaming_apply(q, k, v, m, l, scale, axis,
                               out_dtype=torch.float32)
    err32 = compare(f"streaming_apply fp32 out {tag}", out32,
                    sa.streaming_apply_reference(q, k, v, m, l, scale, axis,
                                                 out_dtype=torch.float32),
                    ATTN_TOL[dn])
    got = {"dv": sa.streaming_dv(q, k, g, m, l, scale, axis)}
    corr = sa.streaming_correction(g, v, out32, got["dv"], axis)
    got["dk"] = sa.streaming_dk(q, k, v, g, m, l, corr, scale, axis)
    got["dq"] = sa.streaming_dq(q, k, v, g, m, l, corr, scale, axis)
    check_bwd_mma(sa, tag, q, k, v, g, got, bwd0)
    plain = {"dv": sa.streaming_dv_reference(q, k, g, m, l, scale, axis),
             "dk": sa.streaming_dk_reference(q, k, v, g, m, l, corr, scale,
                                             axis),
             "dq": sa.streaming_dq_reference(q, k, v, g, m, l, corr, scale,
                                             axis)}
    truth = None
    if dtype == torch.bfloat16 and axis == "q":
        tq, tk, _ = float64_truth(torch, q, k, v, g, scale, axis, [0, 1])
        truth = {"dq": tq, "dk": tk}
    bwd = []
    for name in ("dv", "dk", "dq"):
        tol, extra = BWD_TOL[dn], ""
        if truth is not None and name != "dv":
            tol, extra = truth_tol(f"streaming_{name}", tag, got[name],
                                   plain[name], truth[name])
        e = compare_bwd(f"streaming_{name} {tag}", got[name], plain[name],
                        tol)
        bwd.append(f"{name} err abs {e[0]:.2e} rel {e[1]:.2e}{extra}")
    dv_wgmma = sa.apply_takes_wgmma(k, q, g, got["dv"])
    wg_apply = sa.apply_takes_wgmma(q, k, v, out32)
    wg_stats = sa.stats_takes_wgmma(q, k)
    da_wgmma = sa.da_takes_wgmma(q, k, v, g, got["dk"])
    moved = (sa.streaming_apply.mma_launches - mma0[0],
             sa.streaming_stats.mma_launches - mma0[1],
             sa.streaming_apply.wgmma_launches - mma0[2],
             sa.streaming_stats.wgmma_launches - mma0[3])
    if moved != (2 * wg_apply, 2 * wg_stats, 2 * wg_apply, 2 * wg_stats):
        raise AssertionError(f"streaming {tag}: launches (apply, stats "
                             f"tensor-core; apply, stats wgmma) {moved}, the "
                             f"admissions say apply {wg_apply}, stats "
                             f"{wg_stats}")
    fwd = {True: "wgmma", False: "CUDA-core"}
    log(f"streaming {tag} ({fwd[wg_stats]} stats, "
        f"{fwd[wg_apply]} apply, {fwd[dv_wgmma]} dV, "
        f"{fwd[da_wgmma]} dK and dQ)  {err_text(err, ATTN_TOL[dn])}; "
        f"fp32-output apply {err_text(err32, ATTN_TOL[dn])}; "
        + "; ".join(bwd))


def check_stream_predicates(torch):
    """The Python mirrors of the streaming admissions (da_admits_wgmma,
    admits_wgmma (for both wgmma forward kernels, and for dV on the apply
    kernel with q and k swapped), da_wgmma_smem_bytes, da_wgmma_stages,
    wgmma_smem_bytes, wgmma_stages, wgmma_plan) against the C functions,
    over D = 8..2560, several S, both dtypes and three layouts: aligned, a
    pointer off by 8 bytes, a row stride off by 4 elements."""
    import ctypes
    from sdm_tpu_torch.kernels import _build
    from sdm_tpu_torch.kernels import streaming_attention as sa
    lib = _build.library("streaming_attention", sa._SIGNATURES)
    four = (ctypes.c_int * 4)()
    checked = 0
    for d in range(8, 2561, 8):
        lib.sdm_streaming_da_wgmma_smem(d, four)
        on = d % 128 == 0 and d <= sa.DA_MAX_D
        mirror = ((sa.da_wgmma_smem_bytes(d), sa.da_wgmma_stages(d)) if on
                  else (0, 0))
        if tuple(four)[:2] != mirror:
            raise AssertionError(f"da_wgmma_smem_bytes/da_wgmma_stages({d}) "
                                 f"disagree with C: {tuple(four)[:2]}")
        if d % 64 == 0 and d <= 1024:
            lib.sdm_streaming_wgmma_smem(d, four)
            if tuple(four) != (*sa.wgmma_smem_bytes(d), *sa.wgmma_stages(d)):
                raise AssertionError(f"wgmma_smem_bytes/wgmma_stages({d}) "
                                     f"disagree with C: {tuple(four)}")
            lib.sdm_streaming_wgmma_plan(d, four)
            if tuple(four) != sa.wgmma_plan(d):
                raise AssertionError(f"wgmma_plan({d}) disagrees with C: "
                                     f"{tuple(four)}")
        for s_len in (64, 96, 300, 1024, 4096):
            for dt, dtype in ((0, torch.float32), (1, torch.bfloat16)):
                for ptr_off, ss_off in ((0, 0), (8, 0), (0, 4)):
                    ptrs = [0x10000, 0x20000 + ptr_off, 0x30000, 0x40000]
                    strides = [(s_len * 3 * d, 3 * d + ss_off)] * 3 + [
                        (s_len * d, d)]
                    cptrs = (ctypes.c_void_p * 4)(*ptrs)
                    cstr = (ctypes.c_longlong * 8)(*[x for st in strides
                                                     for x in st])
                    # dK and dQ: q, k, v, g and out.
                    dptrs = ptrs[:3] + [0x50000, ptrs[3]]
                    dstr = strides[:3] + [(s_len * d, d)] * 2
                    cdptrs = (ctypes.c_void_p * 5)(*dptrs)
                    cdstr = (ctypes.c_longlong * 10)(*[x for st in dstr
                                                       for x in st])
                    # dV on the apply kernel: k, q (views), g and the fp32
                    # dv (contiguous), as sdm_streaming_dv passes them.
                    vptrs = [ptrs[1], ptrs[0], 0x50000, ptrs[3]]
                    vstr = [strides[1], strides[0], (s_len * d, d),
                            (s_len * d, d)]
                    cvptrs = (ctypes.c_void_p * 4)(*vptrs)
                    cvstr = (ctypes.c_longlong * 8)(*[x for st in vstr
                                                      for x in st])
                    pairs = (
                        ("dV wgmma apply", lib.sdm_streaming_apply_takes_wgmma(
                            cvptrs, cvstr, s_len, d, dt),
                         sa.admits_wgmma(dtype, s_len, d, vptrs, vstr)),
                        ("wgmma apply", lib.sdm_streaming_apply_takes_wgmma(
                            cptrs, cstr, s_len, d, dt),
                         sa.admits_wgmma(dtype, s_len, d, ptrs, strides)),
                        ("wgmma stats", lib.sdm_streaming_stats_takes_wgmma(
                            cptrs, cstr, s_len, d, dt),
                         sa.admits_wgmma(dtype, s_len, d, ptrs[:2],
                                         strides[:2])),
                        ("dA", lib.sdm_streaming_da_takes_wgmma(
                            cdptrs, cdstr, s_len, d, dt),
                         sa.da_admits_wgmma(dtype, s_len, d, dptrs, dstr)))
                    for what, got, mirror in pairs:
                        if bool(got) != mirror:
                            raise AssertionError(
                                f"{what} admission mirror disagrees with C "
                                f"at S={s_len} D={d} dtype={dtype} pointer "
                                f"+{ptr_off} stride +{ss_off}")
                        checked += 1
    log(f"streaming admissions: the Python mirrors agree with the C "
        f"predicates in {checked} cases (D = 8..2560, S in 64, 96, 300, "
        f"1024, 4096, both dtypes, three layouts), with the wgmma "
        f"forward's shared memory, stages and plan (D = 64..1024) and with "
        f"stream_da_wgmma's shared memory and stages (D = 8..2560)")


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
    mma0 = fused_attention.mma_launches
    got = fused_attention(q, k, v, scale, axis)
    mma = fused_attention.mma_launches - mma0
    if mma != (dtype == torch.bfloat16):
        raise AssertionError(f"attention {dn} S={s_len} D={d}: {mma} mma "
                             "launches; every bf16 U-Net shape takes the "
                             "tensor cores")
    want = attention_reference(q, k, v, scale, axis)
    name = f"attention {dn} S={s_len} D={d} {axis}"
    err = compare(name, got, want, ATTN_TOL[dn])
    must_fail(name, got, attention_reference(q, k, v, scale, other),
              ATTN_TOL[dn])
    reps = _reps(s_len, dn)
    ms = time_ms(lambda: fused_attention(q, k, v, scale, axis), reps)
    # The device time alone: at the small shapes the wrapper's host time
    # (checks, four TMA maps, two launches) can exceed the kernels'.
    queued = time_queued_ms(lambda: fused_attention(q, k, v, scale, axis),
                            reps)
    plain = time_ms(lambda: attention_reference(q, k, v, scale, axis), reps)
    lib = lib_queued = None
    if axis == "k":
        qh, kh, vh = (a.transpose(1, 2) for a in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                      scale=scale)
        lib = time_ms(sdpa, reps)
        lib_queued = time_queued_ms(sdpa, reps)
    nbytes = 4 * BATCH * s_len * d * isz
    # The function's work is Q K^T and P V, 4 S^2 D a row of the batch (the
    # bound); the kernels do 6 S^2 D (the stats pass computes Q K^T too):
    # their TFLOP/s count that.
    ops = 4.0 * BATCH * s_len * s_len * d
    b, by = bound_ms(nbytes, ops, dn)
    results.append(dict(kernel="attention", model=model, dtype=dn, axis=axis,
                        shape=[BATCH, s_len, 1, d],
                        max_abs_err=err[0], max_rel_err=err[1],
                        tol=ATTN_TOL[dn], ms=ms, plain_ms=plain,
                        library_ms=lib, bound_ms=b, bound_by=by,
                        queued_ms=queued, library_queued_ms=lib_queued,
                        tflops=6.0 * BATCH * s_len * s_len * d / queued / 1e9))
    log(f"attention {dn:8s} S={s_len:4d} D={d:4d} {axis}  "
        f"{err_text(err, ATTN_TOL[dn])}  wrong axis fails  "
        f"kernel {ms:.4f} ms, queued {queued:.4f} "
        f"({6.0 * BATCH * s_len * s_len * d / queued / 1e9:.0f} TFLOP/s)  "
        f"plain {plain:.4f}  "
        f"sdpa {lib if lib is None else round(lib, 4)}, queued "
        f"{lib_queued if lib_queued is None else round(lib_queued, 4)}  "
        f"bound {b:.4f} ({by})")


ROUTE_NAMES = {0: "one C call, CUDA cores", 1: "one C call, four launches",
               2: "one C call, three launches, projection in the apply",
               None: "composed: linear, streaming, linear"}


def block_case(torch, randn, results, model, dtype, s_len, d, axis):
    """The block against its plain version on the same inputs (and the
    wrong axis, which must fail). A whole-S block is one C call: its route
    counters move as `block_route` says (`wgmma_launches` at route 1 or 2,
    `fused_out_launches` at 2) and `linear` and `fused_attention` do not;
    the streaming block (S = 4096) runs `linear` twice. Timed back to back
    and queued behind a sleep kernel (the device time alone)."""
    from sdm_tpu_torch.kernels import attention_block as ab
    from sdm_tpu_torch.kernels.attention import fused_attention
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
    fab = ab.fused_attention_block
    route = (ab.block_route(dtype, BATCH, s_len, c, d,
                            (tok.data_ptr(), w_qkv.data_ptr(),
                             w_out.data_ptr(), 0, 0))
             if ab._whole_s(tok, w_out) else None)
    counts = lambda: (fab.wgmma_launches, fab.fused_out_launches,
                      ab.linear.launches, fused_attention.launches)
    before = counts()
    got = fab(*args)
    moved = tuple(x - y for x, y in zip(counts(), before))
    want_moved = ((0, 0, 2, 0) if route is None
                  else (int(route >= 1), int(route == 2), 0, 0))
    name = f"attention_block {dn} S={s_len} C={c} {axis}"
    if moved != want_moved:
        raise AssertionError(f"{name}: (wgmma, fused_out, linear, "
                             f"fused_attention) moved {moved}, route "
                             f"{route} wants {want_moved}")
    if dn == "bfloat16" and (route == 2) != ((s_len, c) in FUSED_OUT_SHAPES):
        raise AssertionError(f"{name}: route {route}, FUSED_OUT_SHAPES "
                             f"{FUSED_OUT_SHAPES}")
    want = ab.attention_block_reference(*args)
    err = compare(name, got, want, ATTN_TOL[dn])
    must_fail(name, got, ab.attention_block_reference(*args[:-1], other),
              ATTN_TOL[dn])
    reps = _reps(s_len, dn)
    ms = time_ms(lambda: fab(*args), reps)
    queued = time_queued_ms(lambda: fab(*args), reps)
    plain = time_ms(lambda: ab.attention_block_reference(*args), reps)
    nbytes = (2 * BATCH * s_len * c + 4 * c * d) * isz
    ops = (2.0 * BATCH * s_len * c * 4 * d
           + 4.0 * BATCH * s_len * s_len * d)
    b, by = bound_ms(nbytes, ops, dn)
    results.append(dict(kernel="attention_block", model=model, dtype=dn,
                        axis=axis, shape=[BATCH, s_len, c],
                        route=route, max_abs_err=err[0], max_rel_err=err[1],
                        tol=ATTN_TOL[dn], ms=ms, queued_ms=queued,
                        plain_ms=plain, library_ms=None, bound_ms=b,
                        bound_by=by))
    log(f"attention_block {dn:8s} S={s_len:4d} C={c:4d} {axis}  "
        f"{err_text(err, ATTN_TOL[dn])}  wrong axis fails  "
        f"route {route} ({ROUTE_NAMES[route]})  kernel {ms:.4f} ms, queued "
        f"{queued:.4f}  plain {plain:.4f}  bound {b:.4f} ({by})")
    if axis == "q":
        linear_case(torch, randn, results, model, dtype, tok, w_qkv, b_qkv,
                    w_out, b_out)


def check_block_routes(torch):
    """`block_route` (kernels/attention_block.py) against the C one
    (sdm_attention_block_route) over S, (C, d_k), both dtypes, batch 1, 2,
    16 and 32 and each pointer off 16 bytes in turn; and at batch 16, bf16,
    route 2 at exactly the FUSED_OUT_SHAPES among both U-Nets' whole-S
    blocks."""
    from sdm_tpu_torch.kernels import _build
    from sdm_tpu_torch.kernels import attention_block as ab
    lib = _build.library("attention_block", ab._BLOCK_SIGNATURES)
    checked = 0
    for n in (1, 2, 16, 32):
        for s_len in (64, 96, 256, 512, 1024, 3200, 3264, 4096):
            for c, d in ((512, 512), (1024, 1024), (768, 768), (128, 128),
                         (72, 72), (512, 256), (1024, 512)):
                for dt, dtype in ((0, torch.float32), (1, torch.bfloat16)):
                    for off in range(6):
                        ptrs = [0x100000 * (i + 1) + (8 if off == i + 1
                                                      else 0)
                                for i in range(5)]
                        got = lib.sdm_attention_block_route(*ptrs, n, s_len,
                                                            c, d, dt)
                        mirror = ab.block_route(dtype, n, s_len, c, d, ptrs)
                        if got != mirror:
                            raise AssertionError(
                                f"block_route disagrees with C at N={n} "
                                f"S={s_len} C={c} d_k={d} {dtype} pointer "
                                f"{off} off: {got} vs {mirror}")
                        checked += 1
    whole = [sh for sh in BLOCK_SHAPES + SR_BLOCK_SHAPES if sh[0] <= 1024]
    fused = sorted({sh for sh in whole if ab.block_route(
        torch.bfloat16, BATCH, sh[0], sh[1], sh[1], [0] * 5) == 2})
    if fused != sorted(FUSED_OUT_SHAPES):
        raise AssertionError(f"route 2 at {fused}, FUSED_OUT_SHAPES "
                             f"{FUSED_OUT_SHAPES}")
    log(f"block routes: the Python mirror agrees with the C function in "
        f"{checked} cases; route 2 (projection in the apply) at {fused}")


def linear_case(torch, randn, results, model, dtype, tok, w_qkv, b_qkv,
                w_out, b_out):
    """The block's two projections, `linear` (csrc/linear.cu) against its
    plain version `linear_reference` on the same inputs, with and without
    the residual epilogue, each bf16 launch on the wgmma kernel
    (`linear.mma_launches`): qkv = tok W_qkv^T + b and out = r W_out^T + b
    (+ tok). Timed without the residual beside F.linear (cuBLAS) on the
    same inputs, a yardstick only: nothing on the port's path calls
    F.linear. Both also queued (`time_queued_ms`, the device time alone:
    at the small projections the wrapper's host time exceeds the kernel's);
    TFLOP/s: 2 M N K over the queued time."""
    import torch.nn.functional as F
    from sdm_tpu_torch.kernels.attention_block import (linear,
                                                       linear_reference)
    dn = str(dtype).split(".")[-1]
    isz = torch.tensor([], dtype=dtype).element_size()
    tok2 = tok.reshape(-1, tok.shape[-1])
    r = randn((tok2.shape[0], w_out.shape[1]), dtype)
    for what, x, w, bias, res in (("qkv", tok2, w_qkv, b_qkv, None),
                                  ("out", r, w_out, b_out, tok2)):
        (m, kk), n = x.shape, w.shape[0]
        name = f"linear {dn} {what} M={m} N={n} K={kk}"
        errs = [linear_check(torch, name, x, w, bias, None)]
        if res is not None:
            errs.append(linear_check(torch, f"{name} + residual", x, w, bias,
                                     res))
        ms = time_ms(lambda: linear(x, w, bias), 10)
        plain = time_ms(lambda: linear_reference(x, w, bias), 10)
        lib = time_ms(lambda: F.linear(x, w, bias), 10)
        queued = time_queued_ms(lambda: linear(x, w, bias), 10)
        lib_queued = time_queued_ms(lambda: F.linear(x, w, bias), 10)
        flop = 2.0 * m * n * kk
        b, by = bound_ms((m * kk + n * kk + m * n) * isz + n * isz, flop, dn)
        err = max(errs)
        results.append(dict(kernel="linear", model=model, dtype=dn,
                            projection=what, shape=[m, n, kk],
                            max_abs_err=err[0], max_rel_err=err[1],
                            tol=ATTN_TOL[dn], ms=ms, plain_ms=plain,
                            library_ms=lib, bound_ms=b, bound_by=by,
                            queued_ms=queued, library_queued_ms=lib_queued,
                            tflops=flop / queued / 1e9,
                            library_tflops=flop / lib_queued / 1e9))
        log(f"{name}: {err_text(err, ATTN_TOL[dn])}"
            f"{' (also with the residual)' if res is not None else ''}  "
            f"kernel {ms:.4f} ms, queued {queued:.4f} "
            f"({flop / queued / 1e9:.0f} TFLOP/s)  plain {plain:.4f}  "
            f"F.linear {lib:.4f}, queued {lib_queued:.4f} "
            f"({flop / lib_queued / 1e9:.0f})  bound {b:.4f} ({by})")


def linear_check(torch, name, x, w, bias, res):
    """One `linear` launch against `linear_reference` under ATTN_TOL; the
    launch takes the wgmma kernel exactly when `linear_takes_wgmma` says
    so, and every bf16 U-Net projection does."""
    from sdm_tpu_torch.kernels.attention_block import (
        linear, linear_reference, linear_takes_wgmma)
    dn = str(x.dtype).split(".")[-1]
    mma0 = linear.mma_launches
    got = linear(x, w, bias, residual=res)
    mma = linear.mma_launches - mma0
    if mma != linear_takes_wgmma(x, w, res):
        raise AssertionError(f"{name}: {mma} wgmma launches, the admission "
                             f"says {linear_takes_wgmma(x, w, res)}")
    return compare(name, got, linear_reference(x, w, bias, residual=res),
                   ATTN_TOL[dn])


def linear_off_grid(torch, randn, results):
    """`linear` off the U-Net's shapes, each against its plain version: a
    ragged bf16 M = 300, N = 200 (boxes past M and N zero-filled by TMA,
    the 16-byte stores masked), an odd N = 197 (the pairs' single-element
    stores) and K = 520 (an 8-column tail that TMA zero-fills past K in the
    last 64-deep stage), all on the wgmma kernel; a row stride off 8
    elements, which the admission refuses to the CUDA cores (no 16-byte
    TMA stride). Then the Python mirrors `linear_admits_wgmma` and
    `linear_wgmma_tile` against the C functions."""
    from sdm_tpu_torch.kernels import _build
    from sdm_tpu_torch.kernels import attention_block as ab
    bf = torch.bfloat16
    for m, n, kk, ldx, mma in ((300, 200, 512, 512, True),
                               (300, 197, 512, 512, True),
                               (300, 200, 520, 520, True),
                               (300, 200, 512, 516, False)):
        bnd = 1.0 / math.sqrt(kk)
        x = randn((m, ldx), bf, std=QK_STD)[:, :kk]
        w = randn((n, kk), bf, std=bnd)
        bias = randn((n,), torch.float32, std=bnd)
        res = randn((m, n), bf, std=QK_STD)
        if ab.linear_takes_wgmma(x, w, res) != mma:
            raise AssertionError(f"linear M={m} N={n} K={kk} ldx={ldx}: "
                                 f"admission {not mma}, expected {mma}")
        for r in (None, res):
            name = (f"linear bfloat16 M={m} N={n} K={kk} ldx={ldx}"
                    f"{' + residual' if r is not None else ''}")
            err = linear_check(torch, name, x, w, bias, r)
            results.append(dict(kernel="linear_check", check=name, mma=mma,
                                max_abs_err=err[0], max_rel_err=err[1]))
            log(f"{name} ({'wgmma' if mma else 'CUDA-core, refused'})  "
                f"{err_text(err, ATTN_TOL['bfloat16'])}")
    lib = _build.library("linear", ab._SIGNATURES)
    checked = 0
    for dt, dtype in ((0, torch.float32), (1, bf)):
        for kk in (0, 8, 32, 64, 500, 512, 516, 520, 1024):
            for ldx_off in (0, 4, 8):
                for x_off, w_off, r_off in ((0, 0, 0), (8, 0, 0), (0, 8, 0),
                                            (0, 0, 8), (0, 0, None)):
                    ptrs = [0x10000 + x_off, 0x20000 + w_off,
                            None if r_off is None else 0x30000 + r_off]
                    got = lib.sdm_linear_takes_wgmma(ptrs[0], kk + ldx_off,
                                                     ptrs[1], ptrs[2], kk, dt)
                    if bool(got) != ab.linear_admits_wgmma(dtype, kk,
                                                           kk + ldx_off, ptrs):
                        raise AssertionError(
                            f"linear_admits_wgmma disagrees with C at {dtype} "
                            f"K={kk} ldx={kk + ldx_off} pointers {ptrs}")
                    checked += 1
    for m in (1, 64, 300, 1024, 2048, 4096, 16384, 65536):
        for n in (8, 200, 512, 1024, 1536, 3072):
            if lib.sdm_linear_wgmma_tile(m, n) != ab.linear_wgmma_tile(m, n):
                raise AssertionError(f"linear_wgmma_tile disagrees with C at "
                                     f"M={m} N={n}")
            checked += 1
    log(f"linear admissions: the Python mirrors agree with the C functions "
        f"in {checked} cases (both dtypes, K and row strides on and off the "
        "grid, each pointer off 16 bytes, with and without a residual; the "
        "tile rule over M x N)")


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

    err_m, err_l = stats_check(torch, q, k, scale, axis, tag)
    m, l = sa.streaming_stats(q, k, scale, axis)
    before = sa.streaming_apply.wgmma_launches
    out = sa.streaming_apply(q, k, v, m, l, scale, axis)
    wgmma = sa.apply_takes_wgmma(q, k, v, out)
    if sa.streaming_apply.wgmma_launches - before != wgmma or (
            dtype == torch.bfloat16 and not wgmma):
        raise AssertionError(f"streaming_apply {tag}: wgmma launches "
                             f"{sa.streaming_apply.wgmma_launches - before}, "
                             f"the admission says {wgmma}")
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
            f"{err_text(err_l, STATS_TOL['l'])} (wrong axis fails); apply "
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


def stats_check(torch, q, k, scale, axis, tag):
    """streaming_stats against its plain version on (q, k), and against
    the plain version of the other axis, which must fail for m and for l;
    the launch must take stream_stats_wgmma (and count as a tensor-core
    launch) exactly when its mirror says so. Returns the m and l errors."""
    from sdm_tpu_torch.kernels import streaming_attention as sa
    other = "k" if axis == "q" else "q"
    before = (sa.streaming_stats.mma_launches,
              sa.streaming_stats.wgmma_launches)
    m, l = sa.streaming_stats(q, k, scale, axis)
    moved = (sa.streaming_stats.mma_launches - before[0],
             sa.streaming_stats.wgmma_launches - before[1])
    wgmma = sa.stats_takes_wgmma(q, k)
    if moved != (int(wgmma), int(wgmma)):
        raise AssertionError(f"streaming_stats {tag}: (tensor-core, wgmma) "
                             f"launches {moved}, the admission says wgmma "
                             f"{wgmma}")
    m_ref, l_ref = sa.streaming_stats_reference(q, k, scale, axis)
    err_m = compare(f"streaming_stats m {tag}", m, m_ref, STATS_TOL["m"])
    err_l = compare(f"streaming_stats l {tag}", l, l_ref, STATS_TOL["l"])
    m_o, l_o = sa.streaming_stats_reference(q, k, scale, other)
    must_fail(f"streaming_stats m {tag}", m, m_o, STATS_TOL["m"])
    must_fail(f"streaming_stats l {tag}", l, l_o, STATS_TOL["l"])
    return err_m, err_l


def stats_case(torch, randn, results, model, dtype, s_len, d, axis,
               views=False):
    """The stats kernel alone at one shape (batch 16): `stats_check`, then
    kernel and plain times beside the bound. `views`: q and k are strided
    views of one (16, S, 3D) qkv buffer, as the attention block passes
    them."""
    from sdm_tpu_torch.kernels import streaming_attention as sa
    dn = str(dtype).split(".")[-1]
    isz = torch.tensor([], dtype=dtype).element_size()
    if views:
        q, k, _ = randn((BATCH, s_len, 3 * d), dtype, std=QK_STD).split(
            d, dim=-1)
    else:
        q, k = (randn((BATCH, s_len, d), dtype, std=QK_STD) for _ in range(2))
    if dtype == torch.bfloat16 and not sa.stats_takes_wgmma(q, k):
        raise AssertionError(f"streaming_stats {dn} S={s_len} D={d}: a bf16 "
                             "U-Net shape off the tensor cores")
    scale = d ** -0.5
    tag = f"{dn} S={s_len} D={d} {axis}" + (" (qkv views)" if views else "")
    err_m, err_l = stats_check(torch, q, k, scale, axis, tag)
    reps = _reps(s_len, dn)
    ms = time_ms(lambda: sa.streaming_stats(q, k, scale, axis), reps)
    plain = time_ms(lambda: sa.streaming_stats_reference(q, k, scale, axis),
                    reps)
    b, by = bound_ms(2 * BATCH * s_len * d * isz + 2 * BATCH * s_len * 4,
                     2.0 * BATCH * s_len * s_len * d, dn)
    results.append(dict(kernel="stats", model=model, dtype=dn, axis=axis,
                        shape=[BATCH, s_len, d], views=views,
                        max_abs_err=max(err_m[0], err_l[0]),
                        max_rel_err=max(err_m[1], err_l[1]), tol=STATS_TOL,
                        ms=ms, plain_ms=plain, library_ms=None, bound_ms=b,
                        bound_by=by))
    log(f"streaming_stats {tag}: m {err_text(err_m, STATS_TOL['m'])}; l "
        f"{err_text(err_l, STATS_TOL['l'])}; wrong axis fails; kernel "
        f"{ms:.4f} ms  plain {plain:.4f}  bound {b:.4f} ({by})")


def bwd_error(got, truth):
    """max |got - truth| over max |truth|."""
    return ((got.double() - truth).abs().max()
            / truth.abs().max().clamp_min(1e-30)).item()


def float64_truth(torch, q, k, v, g, scale, axis, rows):
    """dQ, dK, dV of softmax(q k^T scale, axis) v against g, in float64 on
    the same (rounded) inputs, for batch rows `rows`; dense, one row at a
    time."""
    grads = [[], [], []]
    for b in rows:
        qb, kb, vb = (t[b].double().requires_grad_() for t in (q, k, v))
        p = torch.softmax(qb @ kb.T * scale, dim=0 if axis == "q" else 1)
        for acc, gr in zip(grads, torch.autograd.grad(p @ vb, (qb, kb, vb),
                                                      g[b].double())):
            acc.append(gr)
        del p
    return [torch.stack(a) for a in grads]


def truth_tol(name, tag, got, plain, truth):
    """The bf16 query-axis bound through the float64 truth (BWD_TRUTH) for
    `got` on the truth's batch rows: raises when the kernel's error is past
    `mult` x the plain version's + `add`; returns the tolerance against the
    plain version that follows from it (the triangle inequality through the
    truth, in units of max|truth|) and a note for the log."""
    rows = list(range(truth.shape[0]))
    e_k = bwd_error(got[rows], truth)
    e_p = bwd_error(plain[rows], truth)
    limit = BWD_TRUTH["mult"] * e_p + BWD_TRUTH["add"]
    if not e_k <= limit:
        raise AssertionError(
            f"{name} {tag}: error against float64 truth {e_k:.3e} (of "
            f"max|truth|) exceeds {BWD_TRUTH['mult']} x the plain bf16 "
            f"version's {e_p:.3e} + {BWD_TRUTH['add']}")
    tol = dict(atol=0.0, rtol=0.0, of_max=0.0,
               atol_abs=(limit + e_p) * truth.abs().max().item())
    return tol, (f" vs float64 truth {e_k:.3e} (plain {e_p:.3e}, limit "
                 f"{limit:.3e})")


def streaming_bwd_case(torch, randn, results, dtype, s_len, d, axis):
    """The three backward kernels, each against its plain version on the
    same inputs (the stats of the forward kernel, and corr from the dV
    kernel), and against the plain version of the other softmax axis, which
    must fail. bf16 on the q axis is also held to a float64 truth (see
    BWD_TRUTH). The tensor-core counts of dV, dK and dQ (`mma_launches`,
    `wgmma_launches`) must move as the Python mirrors of the admissions
    say, and in bf16 at the SR model's (4096, 512) every dV must be a
    wgmma launch."""
    import torch.nn.functional as F
    from sdm_tpu_torch.kernels import streaming_attention as sa
    dn = str(dtype).split(".")[-1]
    isz = torch.tensor([], dtype=dtype).element_size()
    other = "k" if axis == "q" else "q"
    q, k = (randn((BATCH, s_len, d), dtype, std=QK_STD) for _ in range(2))
    v, g = (randn((BATCH, s_len, d), dtype) for _ in range(2))
    scale = d ** -0.5
    tag = f"{dn} S={s_len} D={d} {axis}"
    fwd = {}
    for ax in (axis, other):
        m, l = sa.streaming_stats(q, k, scale, ax)
        out32 = sa.streaming_apply(q, k, v, m, l, scale, ax,
                                   out_dtype=torch.float32)
        fwd[ax] = (m, l, out32)
    m, l, out32 = fwd[axis]
    # The fp32-output apply (the key-axis training forward keeps it as a
    # residual) against its plain version, with the bound of the output in
    # the input dtype: the inputs are the same, only the final rounding is
    # gone.
    err32 = compare(f"streaming_apply fp32 out {tag}", out32,
                    sa.streaming_apply_reference(q, k, v, m, l, scale, axis,
                                                 out_dtype=torch.float32),
                    ATTN_TOL[dn])
    mma0 = bwd_mma_counts(sa)
    dv = sa.streaming_dv(q, k, g, m, l, scale, axis)
    corr = sa.streaming_correction(g, v, out32, dv, axis)
    got = {"dv": dv, "dk": sa.streaming_dk(q, k, v, g, m, l, corr, scale,
                                           axis),
           "dq": sa.streaming_dq(q, k, v, g, m, l, corr, scale, axis)}
    check_bwd_mma(sa, tag, q, k, v, g, got, mma0)
    if (dtype == torch.bfloat16 and (s_len, d) == STREAM_SHAPES[0]
            and sa.streaming_dv.wgmma_launches - mma0["dv_wgmma"] != 1):
        raise AssertionError(f"streaming_dv {tag}: not a stream_apply_wgmma "
                             "launch at the SR shape")
    plain = {"dv": sa.streaming_dv_reference(q, k, g, m, l, scale, axis),
             "dk": sa.streaming_dk_reference(q, k, v, g, m, l, corr, scale,
                                             axis),
             "dq": sa.streaming_dq_reference(q, k, v, g, m, l, corr, scale,
                                             axis)}
    mo, lo, out32o = fwd[other]
    dvo = sa.streaming_dv_reference(q, k, g, mo, lo, scale, other)
    corro = sa.streaming_correction(g, v, out32o, dvo, other)
    wrong = {"dv": dvo,
             "dk": sa.streaming_dk_reference(q, k, v, g, mo, lo, corro,
                                             scale, other),
             "dq": sa.streaming_dq_reference(q, k, v, g, mo, lo, corro,
                                             scale, other)}
    truth_rows = list(range(min(BATCH, TRUTH_ROWS)))
    truth = None
    if dtype == torch.bfloat16 and axis == "q":
        tq, tk, tv = float64_truth(torch, q, k, v, g, scale, axis,
                                   truth_rows)
        truth = {"dq": tq, "dk": tk, "dv": tv}
    line = [f"streaming backward {tag}: fp32-output apply "
            f"{err_text(err32, ATTN_TOL[dn])};"]
    errs = {}
    for name in ("dv", "dk", "dq"):
        tol = BWD_TOL[dn]
        extra = ""
        if truth is not None and name != "dv":
            tol, extra = truth_tol(f"streaming_{name}", tag, got[name],
                                   plain[name], truth[name])
        err = compare_bwd(f"streaming_{name} {tag}", got[name], plain[name],
                          tol)
        must_fail_bwd(f"streaming_{name} {tag}", got[name], wrong[name], tol)
        errs[name] = (err, tol, extra)
        line.append(f"{name} err abs {err[0]:.2e} rel {err[1]:.2e}{extra};")
    line.append("wrong axis fails")
    log(" ".join(line))

    reps = _reps(s_len, dn)
    ms = {"dv": time_ms(lambda: sa.streaming_dv(q, k, g, m, l, scale, axis),
                        reps),
          "dk": time_ms(lambda: sa.streaming_dk(q, k, v, g, m, l, corr, scale,
                                                axis), reps),
          "dq": time_ms(lambda: sa.streaming_dq(q, k, v, g, m, l, corr, scale,
                                                axis), reps)}
    plain_ms = {
        "dv": time_ms(lambda: sa.streaming_dv_reference(q, k, g, m, l, scale,
                                                        axis), reps),
        "dk": time_ms(lambda: sa.streaming_dk_reference(
            q, k, v, g, m, l, corr, scale, axis), reps),
        "dq": time_ms(lambda: sa.streaming_dq_reference(
            q, k, v, g, m, l, corr, scale, axis), reps)}
    ms32 = time_ms(lambda: sa.streaming_apply(q, k, v, m, l, scale, axis,
                                              out_dtype=torch.float32), reps)
    pl32 = time_ms(lambda: sa.streaming_apply_reference(
        q, k, v, m, l, scale, axis, out_dtype=torch.float32), reps)
    lib = None
    if axis == "k":
        qh, kh, vh = (a[:, None].detach().requires_grad_() for a in (q, k, v))
        out = F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
        gh = g[:, None]
        lib = time_ms(lambda: torch.autograd.grad(out, (qh, kh, vh), gh,
                                                  retain_graph=True), reps)
        del out
    flops = float(BATCH) * s_len * s_len * d
    tensor_b = BATCH * s_len * d
    stat_b = BATCH * s_len * 4
    # Bytes: each input read once, the fp32 output written once.
    bounds = {"dv": bound_ms(3 * tensor_b * isz + 2 * stat_b + tensor_b * 4,
                             4 * flops, dn),
              "dk": bound_ms(4 * tensor_b * isz + 3 * stat_b + tensor_b * 4,
                             6 * flops, dn),
              "dq": bound_ms(4 * tensor_b * isz + 3 * stat_b + tensor_b * 4,
                             6 * flops, dn)}
    common = dict(model="sr", dtype=dn, axis=axis, shape=[BATCH, s_len, d])
    b32, by32 = bound_ms(3 * tensor_b * isz + 2 * stat_b + tensor_b * 4,
                         4 * flops, dn)
    results.append(dict(common, kernel="streaming_apply_f32out",
                        max_abs_err=err32[0], max_rel_err=err32[1],
                        tol=ATTN_TOL[dn], ms=ms32, plain_ms=pl32,
                        library_ms=None, bound_ms=b32, bound_by=by32))
    for name in ("dv", "dk", "dq"):
        err, tol, extra = errs[name]
        results.append(dict(common, kernel=f"streaming_{name}",
                            max_abs_err=err[0], max_rel_err=err[1],
                            tol=tol, truth=extra.strip() or None,
                            ms=ms[name], plain_ms=plain_ms[name],
                            library_ms=None, bound_ms=bounds[name][0],
                            bound_by=bounds[name][1]))
    results.append(dict(common, kernel="streaming_backward",
                        ms=sum(ms.values()), plain_ms=sum(plain_ms.values()),
                        library_ms=lib,
                        bound_ms=sum(b for b, _ in bounds.values()),
                        bound_by="operations"))
    log(f"streaming backward {tag}: fp32-output apply {ms32:.4f} ms (plain "
        f"{pl32:.4f}, bound {b32:.4f} {by32}), " + ", ".join(
        f"{n} {ms[n]:.4f} ms (plain {plain_ms[n]:.4f}, bound "
        f"{bounds[n][0]:.4f} {bounds[n][1]})" for n in ms)
        + f"; sdpa backward {lib if lib is None else round(lib, 4)}")


def bwd_mma_counts(sa):
    return {"dv": sa.streaming_dv.mma_launches,
            "dv_wgmma": sa.streaming_dv.wgmma_launches,
            "dk": sa.streaming_dk.mma_launches,
            "dq": sa.streaming_dq.mma_launches,
            "dk_wgmma": sa.streaming_dk.wgmma_launches,
            "dq_wgmma": sa.streaming_dq.wgmma_launches}


def check_bwd_mma(sa, tag, q, k, v, g, got, mma0):
    """dV's, dK's and dQ's `mma_launches` and `wgmma_launches` against
    their counts `mma0` before one launch each (outputs `got`): dV moves as
    `apply_takes_wgmma` on its layout (k, q, g, dv) says, dK and dQ as
    `da_takes_wgmma` says."""
    dv = int(sa.apply_takes_wgmma(k, q, g, got["dv"]))
    dk = int(sa.da_takes_wgmma(q, k, v, g, got["dk"]))
    dq = int(sa.da_takes_wgmma(q, k, v, g, got["dq"]))
    want = {"dv": dv, "dv_wgmma": dv, "dk": dk, "dq": dq, "dk_wgmma": dk,
            "dq_wgmma": dq}
    moved = {n: c - mma0[n] for n, c in bwd_mma_counts(sa).items()}
    if moved != want:
        raise AssertionError(f"streaming backward {tag}: tensor-core "
                             f"launches {moved}, the admissions say {want}")


def compare_bwd(name, got, want, tol):
    """`compare`, with an optional absolute bound `atol_abs` on max |got -
    want| (the q-axis bf16 bound through the float64 truth)."""
    if "atol_abs" not in tol:
        return compare(name, got, want, tol)
    got, want = got.float(), want.float()
    if not torch_isfinite_all(got):
        raise AssertionError(f"{name}: non-finite kernel output")
    max_abs = (got - want).abs().max().item()
    if not max_abs <= tol["atol_abs"]:
        raise AssertionError(f"{name}: max abs {max_abs:.3e} past "
                             f"{tol['atol_abs']:.3e}")
    return max_abs, max_abs / max(want.abs().max().item(), 1e-30)


def must_fail_bwd(name, got, wrong, tol):
    try:
        compare_bwd(name, got, wrong, tol)
    except AssertionError:
        return
    raise AssertionError(f"{name}: the wrong softmax axis passes; the check "
                         "cannot see the axis")


def torch_isfinite_all(t):
    import torch
    return bool(torch.isfinite(t).all())


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
                # One AdaGN kernel a call of fused_adagn: the one-pass
                # kernel, not the two-pass kernels.
                got = split["family_launches"].get("adagn (port)", 0)
                want = expected_launches(cfg, 1, 0)["fused_adagn"]
                log(f"{name} unet bfloat16 trace: {got} AdaGN kernel "
                    f"launches for {want} AdaGN calls")
                if got != want:
                    raise AssertionError(f"{name} U-Net trace: {got} AdaGN "
                                         f"kernels for {want} calls")
        del nets, net_k, net_p, out_k, out_p
        torch.cuda.empty_cache()
    return report


def grad_phase(torch, name, cfg, img, streaming):
    """One forward and backward of the U-Net at batch 16 with one t per
    sample (`grad_case`), fp32 parameters computing in fp32 or bf16 as the
    trainers run."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((BATCH, img, img, cfg["in_channel"]), generator=gen,
                    device=dev)
    target = torch.randn((BATCH, img, img, cfg["out_channel"]),
                         generator=gen, device=dev)
    t = torch.randint(1, 1000, (BATCH,), generator=gen, device=dev)
    return {str(dtype).split(".")[-1]: grad_case(
        torch, name, cfg, dtype, x, target, t, streaming=streaming)
        for dtype in (torch.float32, torch.bfloat16)}


def grad_case(torch, name, cfg, dtype, x, target, t, labels=None,
              streaming=0, counters=None):
    """One forward and backward of the U-Net under the trainers' loss (fp32
    MSE against a target), fp32 parameters computing in `dtype`: kernels on
    against off. Gradients are held per tensor in fp32 and as a whole in
    bf16 (GRAD_TOL); the kernels-on backward must launch dV, dK and dQ once
    per `streaming` block. With `counters`, they are zeroed just before the
    kernels-on pass and held just after it to one forward and backward
    call's launches (`expected_grad_launches`)."""
    from sdm_tpu_torch.kernels import streaming_attention as sa
    from sdm_tpu_torch.models import UNet
    dev = torch.device("cuda")
    dn = str(dtype).split(".")[-1]
    backward = (sa.streaming_dv, sa.streaming_dk, sa.streaming_dq)

    def fwd_bwd(net):
        net.zero_grad(set_to_none=True)
        loss = torch.mean(torch.square(net(x, t, labels).float() - target))
        loss.backward()
        return loss.detach()

    torch.manual_seed(0)
    compute = None if dtype == torch.float32 else dtype
    nets = [UNet(**cfg, dtype=compute, use_kernels=on) for on in
            (True, False)]
    nets[1].load_state_dict(nets[0].state_dict())
    nets = [n.to(dev, memory_format=torch.channels_last) for n in nets]
    before = [fn.launches for fn in backward]
    if counters is not None:
        zero_counts(counters)
        before = [0] * len(backward)
    loss_k = fwd_bwd(nets[0])
    torch.cuda.synchronize()
    bwd_launches = {fn.__name__: fn.launches - b
                    for fn, b in zip(backward, before)}
    launches = None
    if counters is not None:
        launches = read_counts(counters)
        check_launches(f"{name} U-Net {dn} forward and backward at batch "
                       f"{x.shape[0]}", launches,
                       expected_grad_launches(cfg, 1, streaming))
    loss_p = fwd_bwd(nets[1])
    pairs = list(zip(nets[0].named_parameters(), nets[1].parameters()))
    for (pname, p_k), p_p in pairs:
        if (p_k.grad is None) != (p_p.grad is None):
            raise AssertionError(f"{name} U-Net {dn}: {pname} has a "
                                 "gradient on one side only")
    pairs = [(pname, p_k.grad.float(), p_p.grad.float())
             for (pname, p_k), p_p in pairs if p_p.grad is not None]
    norms = [g_p.norm().item() for _, _, g_p in pairs]
    floor = GRAD_FLOOR * max(norms)
    per_tensor = {pname: (g_k - g_p).norm().item() / max(n, floor)
                  for (pname, g_k, g_p), n in zip(pairs, norms)}
    whole = (math.sqrt(sum((g_k - g_p).norm().item() ** 2
                           for _, g_k, g_p in pairs))
             / math.sqrt(sum(n ** 2 for n in norms)))
    worst = max(per_tensor, key=per_tensor.get)
    ms_k = time_ms(lambda: fwd_bwd(nets[0]), 2)
    ms_p = time_ms(lambda: fwd_bwd(nets[1]), 2)
    log(f"{name} unet {dn:8s} gradients kernels vs plain: whole "
        f"normwise rel {whole:.3e}, worst tensor {per_tensor[worst]:.3e} "
        f"({worst}), loss {loss_k.item():.6f} vs {loss_p.item():.6f}; "
        f"backward kernel launches {bwd_launches}; forward+backward "
        f"{ms_k:.2f} ms with kernels, {ms_p:.2f} ms plain")
    bound = whole if dtype == torch.bfloat16 else per_tensor[worst]
    if not bound <= GRAD_TOL[dn]:
        raise AssertionError(f"{name} U-Net {dn}: gradients kernels vs "
                             f"plain {bound:.3e} past {GRAD_TOL[dn]}")
    if any(n != streaming for n in bwd_launches.values()):
        raise AssertionError(f"{name} U-Net {dn}: backward kernels "
                             f"launched {bwd_launches}, expected "
                             f"{streaming} each")
    report = dict(whole_rel=whole, worst_tensor=worst,
                  worst_tensor_rel=per_tensor[worst],
                  backward_launches=bwd_launches, ms_kernels=ms_k,
                  ms_plain=ms_p, **({} if launches is None
                                    else {"launches": launches}))
    del nets, pairs
    torch.cuda.empty_cache()
    return report


# Kernel-name fragments -> family for the device-time breakdown; the first
# match wins, so the streaming backward passes (tagged dv_pass, dk_pass,
# dq_pass) come before the other streaming kernels (stream_apply*, and the
# shared stats kernels tagged <streaming>), those before the whole-S
# attention (attn_*: attn_stats_wgmma, attn_apply_wgmma, and the CUDA-core
# attn_stats<..., whole_s> and attn_apply), and the port's kernels and
# cuDNN's convolutions before cuBLAS's GEMMs.
FAMILIES = (("adagn_", "adagn (port)"),
            ("dv_pass", "streaming dV (port)"),
            ("dk_pass", "streaming dK (port)"),
            ("dq_pass", "streaming dQ (port)"),
            ("stream", "streaming attention (port)"),
            ("attn_", "attention (port)"),
            ("linear_", "linear (port)"), ("fprop", "conv (cuDNN)"),
            ("dgrad", "conv (cuDNN)"), ("wgrad", "conv (cuDNN)"),
            ("conv", "conv (cuDNN)"), ("implicit", "conv (cuDNN)"),
            ("gemm", "matmul (cuBLAS)"), ("multi_tensor", "Adam (torch)"),
            ("adam", "Adam (torch)"))


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
    families, family_launches = {}, {}
    for name, ms, count in kernels:
        fam = next((f for frag, f in FAMILIES if frag in name.lower()),
                   "other (elementwise, copies)")
        families[fam] = families.get(fam, 0.0) + ms
        family_launches[fam] = family_launches.get(fam, 0) + count
    top = sorted(kernels, key=lambda k: -k[1])[:10]
    return dict(total_ms=total, launches=sum(c for _, _, c in kernels),
                families=families, family_launches=family_launches,
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


def _export(torch, tmp, name, cfg, img, model_type, cond_t=None,
            ranges=((1, 1000),), objective=None):
    """cfg's U-Net from seed 0 exported as a bundle of one entry per
    (min, max) step range, each with those weights (by default one entry
    over steps 1..1000; the linear schedule 5e-3 -> 9e-3), its entries
    tagged with `objective` ("V") when given; returns its config.json."""
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
                 noise_scheduler="LINEAR", beta1=5e-3, betaT=9e-3)
    if cond_t is not None:
        train["cond_t"] = cond_t
    if objective is not None:
        train["objective"] = objective
    entries = [(dict(train, min_noise_step=lo, max_noise_step=hi), pt)
               for lo, hi in ranges]
    bundle = export_bundle(name, tmp, img_c=3, img_h=img, img_w=img,
                           model_type=model_type, entries=entries)
    return os.path.join(bundle, "config.json")


def expected_launches(cfg, calls, streaming):
    """Launches per kernel for `calls` U-Net calls of cfg: two AdaGN per
    ResidualBlock and one attention block per ResidualBlock of an
    attention layer, down and up. A whole-S block is one C call of the
    block itself, every kernel on the tensor cores (`_wgmma`), and at the
    FUSED_OUT_SHAPES its apply carries the output projection
    (`_fused_out`); it moves no `linear` or `fused_attention` count. The
    `streaming` blocks (the SR model's S = 4096, cfg's blocks of the
    SR_BLOCK_SHAPES where `streaming`, else of BLOCK_SHAPES) run `linear`
    twice and the two streaming passes, every `linear` and every streaming
    stats and streaming apply on the wgmma kernels (`_mma`, the tensor-core
    counts; `_wgmma`, the streaming passes' wgmma counts). Every AdaGN runs
    on a one-pass kernel (`_one_pass`; none on the two passes). Calls
    without a gradient launch no backward kernel."""
    adagn = 2 * 2 * cfg["num_layers"] * cfg["num_resnet_blocks"]
    blocks = 2 * len(cfg["attn_layers"]) * cfg["num_resnet_blocks"]
    shapes = SR_BLOCK_SHAPES if streaming else BLOCK_SHAPES
    fused = (sum(sh in FUSED_OUT_SHAPES for sh in shapes) * blocks
             // len(shapes))
    return {"fused_adagn": adagn * calls,
            "fused_adagn_one_pass": adagn * calls,
            "fused_adagn_two_pass": 0,
            "fused_attention": 0,
            "fused_attention_mma": 0,
            "fused_attention_block": blocks * calls,
            "fused_attention_block_wgmma": (blocks - streaming) * calls,
            "fused_attention_block_fused_out": fused * calls,
            "linear": 2 * streaming * calls,
            "linear_mma": 2 * streaming * calls,
            "streaming_stats": streaming * calls,
            "streaming_stats_mma": streaming * calls,
            "streaming_stats_wgmma": streaming * calls,
            "streaming_apply": streaming * calls,
            "streaming_apply_mma": streaming * calls,
            "streaming_apply_wgmma": streaming * calls,
            "streaming_dv": 0, "streaming_dk": 0, "streaming_dq": 0,
            "streaming_dv_mma": 0, "streaming_dk_mma": 0,
            "streaming_dq_mma": 0, "streaming_dv_wgmma": 0,
            "streaming_dk_wgmma": 0, "streaming_dq_wgmma": 0}


def kernel_counters():
    """The kernels' wrappers, each carrying its launch counts."""
    from sdm_tpu_torch.kernels.adagn import fused_adagn
    from sdm_tpu_torch.kernels.attention import fused_attention
    from sdm_tpu_torch.kernels.attention_block import (fused_attention_block,
                                                       linear)
    from sdm_tpu_torch.kernels.streaming_attention import (
        streaming_apply, streaming_dk, streaming_dq, streaming_dv,
        streaming_stats)
    return [fused_adagn, fused_attention, fused_attention_block, linear,
            streaming_stats, streaming_apply, streaming_dv, streaming_dk,
            streaming_dq]


# The counts beside `launches` that some wrappers keep: the tensor-core
# launches, the streaming passes' and the block's wgmma ones, AdaGN's
# one-pass and two-pass ones, the blocks whose apply carries the output
# projection.
SUB_COUNTS = (("mma_launches", "mma"), ("wgmma_launches", "wgmma"),
              ("one_pass_launches", "one_pass"),
              ("two_pass_launches", "two_pass"),
              ("fused_out_launches", "fused_out"))


def zero_counts(counters):
    """Every launch count to 0, the tensor-core counts (`mma_launches`) of
    the whole-S attention, `linear` and the streaming stats, apply, dV, dK
    and dQ passes, the wgmma counts (`wgmma_launches`) of the streaming
    stats and apply and of the block, the block's `fused_out_launches` and
    AdaGN's one-pass and two-pass counts too."""
    for fn in counters:
        fn.launches = 0
        for name, _ in SUB_COUNTS:
            if hasattr(fn, name):
                setattr(fn, name, 0)


def read_counts(counters):
    """{wrapper name: launches}, with `<name>_mma` for the launches that
    ran the tensor-core kernels (the wgmma ones of fused_attention,
    linear, streaming_stats, streaming_apply, streaming_dv, streaming_dk
    and streaming_dq), `<name>_wgmma` for those of the streaming passes
    and of the block that ran their wgmma kernels,
    fused_attention_block_fused_out for the blocks whose apply carried the
    output projection, and fused_adagn_one_pass / _two_pass for AdaGN's
    calls on its one-pass kernel (adagn_grid) and on the two-pass kernels."""
    out = {fn.__name__: fn.launches for fn in counters}
    for attr, tag in SUB_COUNTS:
        out.update({f"{fn.__name__}_{tag}": getattr(fn, attr)
                    for fn in counters if hasattr(fn, attr)})
    return out


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

        zero_counts(counters)
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
        launches = read_counts(counters)
        stats = engine.stats.snapshot()
    finally:
        server.stop()
    return [got[i] for i in range(4)], launches, stats, t_first


def check_launches(name, launches, expect):
    """Hold a path's launch counts, the tensor-core (`_mma`) ones among
    them, to `expect`."""
    log(f"{name}: launches {launches}, expected {expect}")
    for kernel, n in expect.items():
        if launches[kernel] != n:
            raise AssertionError(f"{name}: {kernel} launched "
                                 f"{launches[kernel]} times, expected {n}")


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
    check_launches(f"{name} served ({batches} batches x {calls // batches} "
                   "U-Net calls)", launches,
                   expected_launches(cfg, calls, streaming))


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


def generation_phase(torch, counters):
    """The DDIM/DDPM generator (generate_images_diffusion) on the flagship
    at full width and depth, random weights from seed 0, bf16, 16 images,
    DDIM step 20 (51 U-Net calls): its images against the serving engine's
    for the same injected noise (normwise, MODEL_TOL's bf16 limit), then a
    two-entry ensemble of the same weights (steps 501-1000, then 1-500) and
    a doodle bundle (6 input channels) with a conditioning image. The
    launch counters are zeroed just before each generator run and read just
    after. Returns the launches of the three runs and a report."""
    import numpy as np
    from sdm_tpu_torch.cli.generate_images_diffusion import \
        generate_images_diffusion
    from sdm_tpu_torch.diffusion.samplers import ddim_step_list
    from sdm_tpu_torch.io.bundles import (build_model_from_bundle,
                                          load_bundle_config)
    from sdm_tpu_torch.serving import SamplerEngine

    quiet = dict(log=lambda *a, **k: None, save_locally=False)
    args = ["-n", str(BATCH), "--diff_alg", "ddim", "--ddim_step_size",
            str(DDIM_STEP), "--dtype", "bfloat16", "-s", "0"]
    total = {}
    report = {}

    def run(name, config, cfg, ranges, **kw):
        zero_counts(counters)
        t0 = time.monotonic()
        images = generate_images_diffusion(["-c", config] + args, **kw,
                                           **quiet)
        wall = time.monotonic() - t0
        launches = read_counts(counters)
        calls = sum(len(ddim_step_list(lo, hi, DDIM_STEP))
                    for lo, hi in ranges)
        check_launches(f"generator ({name}, {calls} U-Net calls)", launches,
                       expected_launches(cfg, calls, 0))
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        if images.shape != (BATCH, IMG, IMG, 3) or \
                not np.isfinite(images).all():
            raise AssertionError(f"generator ({name}): shape {images.shape} "
                                 "or non-finite values")
        return images, wall

    with tempfile.TemporaryDirectory() as tmp:
        config = _export(torch, tmp, "flagship", FLAGSHIP, IMG, "BASE")
        engine = SamplerEngine(config, diff_alg="ddim", step_size=DDIM_STEP,
                               max_batch=BATCH, dtype="bfloat16", log=log)
        want = engine.generate(BATCH, seed=7)
        noise = engine._noise_for(7, BATCH).cpu().numpy()
        del engine
        torch.cuda.empty_cache()
        got, wall = run("flagship", config, FLAGSHIP, ((1, 1000),),
                        noise=noise)
        rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        log(f"generator vs serving engine, same noise: normwise rel "
            f"{rel:.3e} (tol {MODEL_TOL['bfloat16']}), max abs "
            f"{float(np.abs(got - want).max()):.3e}")
        if not rel <= MODEL_TOL["bfloat16"]:
            raise AssertionError(f"generator vs engine: normwise rel {rel}")
        # The rate: a second run, seeded, with the CUDA context, the
        # kernels and cuDNN's plans already warm; then the bundle load
        # alone, the part of the run that is not sampling.
        _, wall2 = run("flagship, timed", config, FLAGSHIP, ((1, 1000),))
        models, folder = load_bundle_config(config)
        t0 = time.monotonic()
        net, _ = build_model_from_bundle(
            models["models"][0], folder, max_T=1000,
            device=torch.device("cuda"), dtype=torch.bfloat16,
            cast_params=True)
        torch.cuda.synchronize()
        load = time.monotonic() - t0
        del net
        log(f"generator: {BATCH} images, DDIM step {DDIM_STEP}, bf16: "
            f"{wall2:.3f} s -> {BATCH / wall2:.3f} img/s, of which the "
            f"bundle load (read, build, cast, upload) {load:.3f} s; the "
            f"first run took {wall:.3f} s")
        report.update(rel_err_vs_engine=rel, seconds=wall2,
                      img_per_s=BATCH / wall2, first_run_seconds=wall,
                      bundle_load_seconds=load)

        config = _export(torch, tmp, "ensemble", FLAGSHIP, IMG, "BASE",
                         ranges=ENSEMBLE)
        _, wall = run("ensemble 501-1000, 1-500", config, FLAGSHIP, ENSEMBLE)
        report["ensemble_seconds"] = wall

        config = _export(torch, tmp, "doodle", DOODLE, IMG, "BASE")
        cond = np.random.default_rng(5).integers(0, 256, (IMG, IMG, 3),
                                                 dtype=np.uint8)
        _, wall = run("doodle", config, DOODLE, ((1, 1000),), cond_img=cond)
        report["doodle_seconds"] = wall
    torch.cuda.empty_cache()
    return total, report


def extensions_phase(torch, counters):
    """The sampler and training extensions at full width and depth, bf16,
    batch 16, seeded random weights (see the module docstring, phase 7).
    The launch counters are zeroed just before each run and read just
    after. Returns the launches of each run and a report."""
    import numpy as np
    import cv2
    from sdm_tpu_torch.cli.generate_images_diffusion import \
        generate_images_diffusion
    from sdm_tpu_torch.diffusion.samplers import (ddim_sample,
                                                  ddim_step_list,
                                                  karras_steps_matching)
    from sdm_tpu_torch.io.bundles import (build_model_from_bundle,
                                          load_bundle_config)
    from sdm_tpu_torch.models import UNet
    from sdm_tpu_torch.ops.schedules import make_schedule
    from sdm_tpu_torch.serving import SamplerEngine
    from sdm_tpu_torch.train.loop import BASE_SPEC

    dev = torch.device("cuda")
    launches, report = {}, {}
    uniform = len(ddim_step_list(1, 1000, DDIM_STEP))
    karras = len(karras_steps_matching(
        1, 1000, DDIM_STEP, make_schedule("LINEAR", max_noise_step=1000)))
    labels = [float(i == 3) for i in range(COND["cond_dim"])]

    def counted(name, cfg, calls, fn, into=launches):
        zero_counts(counters)
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        into[name] = read_counts(counters)
        check_launches(f"{name} ({calls} U-Net calls)", into[name],
                       expected_launches(cfg, calls, 0))
        return out, wall

    def check_images(name, images, n=BATCH):
        if images.shape != (n, IMG, IMG, 3) or not np.isfinite(images).all():
            raise AssertionError(f"{name}: shape {images.shape} or "
                                 "non-finite values")

    with tempfile.TemporaryDirectory() as tmp:
        flagship = _export(torch, tmp, "flagship", FLAGSHIP, IMG, "BASE")
        cond = _export(torch, tmp, "cond", COND, IMG, "BASE")

        # Served: DDIM-50 (the rate the others are read against in this
        # run), dpmpp and heun with Karras spacing, guidance at batch 32.
        for name, bundle, cfg, kw, calls, req in (
                ("served ddim", flagship, FLAGSHIP, dict(diff_alg="ddim"),
                 uniform, {}),
                ("served dpmpp karras", flagship, FLAGSHIP,
                 dict(diff_alg="dpmpp", karras=True), karras, {}),
                ("served heun karras", flagship, FLAGSHIP,
                 dict(diff_alg="heun", karras=True), 2 * karras - 1, {}),
                ("served ddim guidance 3", cond, COND,
                 dict(diff_alg="ddim", guidance=True), uniform,
                 dict(labels=labels, guidance_scale=GUIDANCE_SCALE))):
            engine = SamplerEngine(bundle, step_size=DDIM_STEP,
                                   max_batch=BATCH, dtype="bfloat16",
                                   log=log, **kw)
            engine.generate(BATCH, seed=0, **req)          # warm-up
            images, wall = counted(name, cfg, calls, lambda: engine.generate(
                BATCH, seed=1, **req))
            check_images(name, images)
            log(f"{name}: {BATCH} images in {wall:.3f} s -> "
                f"{BATCH / wall:.3f} img/s ({calls} U-Net calls"
                + (f", each at batch {2 * BATCH})" if kw.get("guidance")
                   else ")"))
            report[name] = dict(seconds=wall, img_per_s=BATCH / wall,
                                calls=calls)
            del engine
            torch.cuda.empty_cache()

        # One guided U-Net call: the doubled batch of 32 (conditional rows,
        # then zero-label rows), kernels on against off, the same bf16
        # weights, held to the model phase's bf16 limit. The guided
        # combine u + s (c - u) scales each branch's difference by |s| and
        # |1 - s|, so it is held to COMBINE_TOL. A comparison: its launches
        # are checked and reported, not counted as the main path's.
        models, folder = load_bundle_config(cond)
        net_k, _ = build_model_from_bundle(models["models"][0], folder,
                                           max_T=1000, device=dev,
                                           dtype=torch.bfloat16,
                                           cast_params=True)
        net_p = UNet.from_config(models["models"][0], dtype=torch.bfloat16,
                                 use_kernels=False)
        net_p.load_state_dict(net_k.state_dict())
        net_p = net_p.to(dev, torch.bfloat16,
                         memory_format=torch.channels_last).eval()
        x = torch.randn((BATCH, IMG, IMG, 3), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(2))
        x2 = torch.cat([x, x])
        lab = torch.tensor(labels, device=dev).expand(BATCH, -1)
        l2 = torch.cat([lab, torch.zeros_like(lab)])
        t = torch.tensor([500], device=dev)
        with torch.inference_mode():
            got, _ = counted("guided call", COND, 1,
                             lambda: net_k(x2, t, l2).float(), into=report)
            want = net_p(x2, t, l2).float()
        rel = ((got - want).norm() / want.norm()).item()

        def combine(out):
            cond_rows, null_rows = out.chunk(2)
            return null_rows + GUIDANCE_SCALE * (cond_rows - null_rows)
        g_k, g_p = combine(got), combine(want)
        rel_g = ((g_k - g_p).norm() / g_p.norm()).item()
        log(f"guided U-Net call at batch 32, kernels vs plain: normwise rel "
            f"{rel:.3e} (tol {MODEL_TOL['bfloat16']}), max abs "
            f"{(got - want).abs().max().item():.3e}; the guided combine "
            f"(scale {GUIDANCE_SCALE}): normwise rel {rel_g:.3e} (tol "
            f"{COMBINE_TOL:.3g})")
        if not rel <= MODEL_TOL["bfloat16"]:
            raise AssertionError(f"guided call kernels vs plain: rel {rel}")
        if not rel_g <= COMBINE_TOL:
            raise AssertionError(f"guided combine kernels vs plain: rel "
                                 f"{rel_g}")
        report["guided_call_rel_err"] = rel
        report["guided_combine_rel_err"] = rel_g
        del net_k, net_p, got, want, g_k, g_p
        torch.cuda.empty_cache()

        # One training micro-batch as grad accumulation gives it to the
        # kernels: batch 8, one t per sample, one-hot labels with the last
        # two rows the null label (as cfg_drop_prob makes them), forward and
        # backward kernels on against off (grad_case, GRAD_TOL), its
        # launches held to one call's. A comparison, as the guided call.
        micro = BATCH // EXT_TRAIN["grad_accum_steps"]
        gen = torch.Generator(device=dev).manual_seed(5)
        xm = torch.randn((micro, IMG, IMG, 3), generator=gen, device=dev)
        target = torch.randn((micro, IMG, IMG, 3), generator=gen,
                             device=dev)
        tm = torch.randint(1, 1000, (micro,), generator=gen, device=dev)
        lm = torch.nn.functional.one_hot(
            torch.randint(0, COND["cond_dim"], (micro,), generator=gen,
                          device=dev), COND["cond_dim"]).float()
        lm[-2:] = 0.0
        report["micro-batch gradients"] = grad_case(
            torch, f"cond micro-batch {micro}", COND, torch.bfloat16, xm,
            target, tm, labels=lm, counters=counters)
        del xm, target, tm, lm

        # Generated: img2img, inpainting (left half kept), a v-bundle.
        rng = np.random.default_rng(6)
        init = os.path.join(tmp, "init.png")
        mask = os.path.join(tmp, "mask.png")
        cv2.imwrite(init, rng.integers(0, 256, (IMG, IMG, 3),
                                       dtype=np.uint8))
        half = np.zeros((IMG, IMG), np.uint8)
        half[:, :IMG // 2] = 255
        cv2.imwrite(mask, half)
        vbundle = _export(torch, tmp, "vflag", FLAGSHIP, IMG, "BASE",
                          objective="V")
        quiet = dict(log=lambda *a, **k: None, save_locally=False)
        common = ["-n", str(BATCH), "--ddim_step_size", str(DDIM_STEP),
                  "--dtype", "bfloat16", "-s", "0"]
        for name, bundle, flags, calls in (
                ("generated img2img", flagship,
                 ["--diff_alg", "ddim", "--init_img_path", init,
                  "--init_noise_step", str(INIT_STEP)],
                 len(ddim_step_list(1, INIT_STEP, DDIM_STEP))),
                ("generated inpainting", flagship,
                 ["--diff_alg", "ddim", "--inpaint_img_path", init,
                  "--inpaint_mask_path", mask], uniform),
                ("generated v-bundle dpmpp", vbundle,
                 ["--diff_alg", "dpmpp"], uniform)):
            images, wall = counted(name, FLAGSHIP, calls, lambda: (
                generate_images_diffusion(["-c", bundle] + common + flags,
                                          **quiet)))
            check_images(name, images)
            if "inpainting" in name:
                known = (cv2.imread(init).astype(np.float32) - 127.5) / 127.5
                dev_known = float(np.abs(images[:, :, :IMG // 2]
                                         - known[:, :IMG // 2]).max())
                log(f"{name}: kept half against the image: max abs "
                    f"{dev_known:.3e}")
                if dev_known > 1e-6:
                    raise AssertionError(f"{name}: kept pixels moved by "
                                         f"{dev_known}")
            log(f"{name}: {BATCH} images in {wall:.3f} s (bundle load "
                f"included) -> {BATCH / wall:.3f} img/s, {calls} U-Net calls")
            report[name] = dict(seconds=wall, img_per_s=BATCH / wall,
                                calls=calls)

        # fp32 bundle: no kernel runs; the images are the plain U-Net's.
        noise = torch.randn((BATCH, IMG, IMG, 3), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(3))
        images, wall = counted("generated fp32", FLAGSHIP, 0, lambda: (
            generate_images_diffusion(
                ["-c", flagship, "-n", str(BATCH), "--diff_alg", "ddim",
                 "--ddim_step_size", str(DDIM_STEP), "--dtype", "float32"],
                noise=noise.cpu().numpy(), **quiet)))
        # The exported weights (_export: seed 0), kernels off.
        torch.manual_seed(0)
        net_p = UNet(**dict(FLAGSHIP, use_kernels=False))
        net_p = net_p.to(dev, memory_format=torch.channels_last).eval()
        with torch.inference_mode():
            want = ddim_sample(net_p, make_schedule(
                "LINEAR", max_noise_step=1000, device=dev), noise,
                ddim_step_size=DDIM_STEP).cpu().numpy()
        rel = float(np.linalg.norm(images - want) / np.linalg.norm(want))
        log(f"generated fp32: 0 kernel launches; against the plain U-Net's "
            f"DDIM: normwise rel {rel:.3e} (tol {MODEL_TOL['float32']}); "
            f"{BATCH} images in {wall:.3f} s")
        if not rel <= MODEL_TOL["float32"]:
            raise AssertionError(f"fp32 generator vs plain: rel {rel}")
        report["generated fp32"] = dict(seconds=wall, rel_err_vs_plain=rel)
        del net_p
        torch.cuda.empty_cache()

    # Trained: the base trainer on the conditional flagship with every
    # extension of the step.
    launches["ext_train"], report["trained"] = train_phase(
        torch, counters, BASE_SPEC, "extended base", COND, IMG, streaming=0,
        extra=EXT_TRAIN)
    return launches, report


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


def train_config(out_dir, data_glob, cfg, img):
    """A reference-format training config for cfg's U-Net at `img`, batch
    16, bf16, kernels on: checkpoints (with a preview) at step 0 only, so
    the run's U-Net calls are its steps plus one preview of 51 calls."""
    out = dict(dataset_path=data_glob,
               use_conditional=cfg["cond_dim"] is not None,
               cond_dim=cfg["cond_dim"],
               out_dir=out_dir, checkpoint_steps=1000, lr_steps=100_000,
               max_epoch=1, plot_img_count=BATCH, flip_imgs=True,
               model_checkpoint=None, load_diffusion_optim=False,
               config_checkpoint=None, diffusion_lr=2e-5,
               batch_size=BATCH, noise_scheduler="LINEAR", beta1=5e-3,
               betaT=9e-3, diffusion_alg="DDIM", skip_step=DDIM_STEP,
               min_noise_step=1, max_noise_step=1000,
               max_actual_noise_step=1000, in_channel=cfg["in_channel"],
               out_channel=cfg["out_channel"], num_layers=cfg["num_layers"],
               num_resnet_block=cfg["num_resnet_blocks"],
               attn_layers=list(cfg["attn_layers"]),
               attn_heads=cfg["num_heads"],
               attn_dim_per_head=cfg["dim_per_head"],
               time_dim=cfg["time_dim"], min_channel=cfg["min_channel"],
               max_channel=cfg["max_channel"], img_recon=cfg["image_recon"],
               compute_dtype="bfloat16", seed=0)
    if cfg is SR:
        out.update(lr_dim=img // 2, sr_dim=img, cond_t=SR_COND_T)
    return out


def expected_grad_launches(cfg, calls, streaming):
    """Launches of `calls` forward+backward U-Net calls: the forward's
    (`expected_launches`, the streaming stats and apply on their wgmma
    kernels), and dV, dK and dQ once per streaming block per call
    backward, every dV on stream_apply_wgmma, every dK and dQ on
    stream_da_wgmma. AdaGN, the whole-S attention and the blocks recompute
    their backward through the plain version, and `linear`'s backward is
    plain matmuls: no launches."""
    out = expected_launches(cfg, calls, streaming)
    for kernel in ("streaming_dv", "streaming_dk", "streaming_dq",
                   "streaming_dv_mma", "streaming_dk_mma",
                   "streaming_dq_mma", "streaming_dv_wgmma",
                   "streaming_dk_wgmma", "streaming_dq_wgmma"):
        out[kernel] = streaming * calls
    return out


def expected_train_launches(cfg, calls, streaming):
    """Launches of a training run of `calls` forward+backward U-Net calls
    (one per step, `grad_accum_steps` per step with accumulation;
    `expected_grad_launches`) and a preview of 1000 // DDIM_STEP + 1 calls
    forward (`expected_launches`)."""
    preview = expected_launches(cfg, 1000 // DDIM_STEP + 1, streaming)
    return {kernel: n + preview[kernel] for kernel, n in
            expected_grad_launches(cfg, calls, streaming).items()}


def write_dataset(tmp, img, doodle=False, cond_dim=None, n=TRAIN_IMAGES,
                  seed=3):
    """n seeded uint8 HWC images in `tmp` (and, for the doodle trainer, as
    many conditioning images, paired with them in a TinyDB file; with
    `cond_dim`, one-hot labels in one). With OpenCV they are PNGs read by
    the dataset's own cv2 decode; a machine without it gets .npy files, read
    under `decoders`. Returns {path (the config's dataset_path), images,
    conds, labels, ext, cv2 (the module or None)}."""
    import numpy as np
    from sdm_tpu_torch.data.tinydb_compat import write_tables
    try:
        import cv2
    except ImportError:
        cv2 = None
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, img, img, 3), dtype=np.uint8)
    conds = (rng.integers(0, 256, (n, img, img, 3), dtype=np.uint8)
             if doodle else None)
    labels = (np.eye(cond_dim, dtype=np.float32)[
        rng.integers(0, cond_dim, n)] if cond_dim is not None else None)
    ext = "npy" if cv2 is None else "png"
    rows = []
    for i in range(n):
        pair = [("im", images[i])] + ([("doodle", conds[i])] if doodle
                                      else [])
        for kind, im in pair:
            path = os.path.join(tmp, f"{kind}_{i}.{ext}")
            if cv2 is None:
                np.save(path, im)
            else:
                cv2.imwrite(path, im)
        if doodle:
            rows.append({"filename": os.path.join(tmp, f"im_{i}.{ext}"),
                         "doodle": os.path.join(tmp, f"doodle_{i}.{ext}")})
        elif labels is not None:
            rows.append(dict({f"l{j}": float(v)
                              for j, v in enumerate(labels[i])},
                             filename=os.path.join(tmp, f"im_{i}.{ext}")))
    if doodle or labels is not None:
        path = os.path.join(tmp, "data.json")
        names = ["doodle"] if doodle else [f"l{j}" for j in range(cond_dim)]
        write_tables(path, {"Data": rows, "Labels": [{"labels": names}]})
    else:
        path = os.path.join(tmp, f"im_*.{ext}")
    return dict(path=path, images=images, conds=conds, labels=labels,
                ext=ext, cv2=cv2)


class decoders:
    """Without OpenCV (cv2 None): the dataset's decode swapped for np.load
    and the grid writer for a log line while the block runs; the loader,
    the trainers and all after them stay the real path."""

    def __init__(self, cv2):
        self.cv2 = cv2

    def __enter__(self):
        import numpy as np
        from sdm_tpu_torch.data import datasets
        from sdm_tpu_torch.train import loop
        self.saved = datasets._imread_u8, loop.plot_sampled_images
        if self.cv2 is None:
            datasets._imread_u8 = np.load
            loop.plot_sampled_images = (
                lambda imgs, file_name, dest_path=None, log=print:
                log(f"{file_name}: not written (no cv2)"))

    def __exit__(self, *exc):
        from sdm_tpu_torch.data import datasets
        from sdm_tpu_torch.train import loop
        datasets._imread_u8, loop.plot_sampled_images = self.saved


def train_phase(torch, counters, spec, name, cfg, img, streaming,
                extra=None):
    """One trainer run at full width (see the module docstring, phase 6),
    its config updated with `extra` (the step's extensions). A
    label-conditional cfg trains on images with one-hot labels from a
    TinyDB file. Returns its launches and a report."""
    import numpy as np
    from sdm_tpu_torch.enums import Objective
    from sdm_tpu_torch.io.checkpoint import load_optimizer_from_checkpoint
    from sdm_tpu_torch.models import UNet
    from sdm_tpu_torch.ops.schedules import make_schedule
    from sdm_tpu_torch.train import loop
    from sdm_tpu_torch.train.step import make_optimizer, make_train_step

    dev = torch.device("cuda")
    extra = extra or {}
    accum = extra.get("grad_accum_steps", 1)
    doodle = spec.dataset == "doodle"
    cond_dim = cfg["cond_dim"]
    with tempfile.TemporaryDirectory() as tmp:
        data = write_dataset(tmp, img, doodle, cond_dim)
        data_path, images, conds, labels, cv2 = (
            data["path"], data["images"], data["conds"], data["labels"],
            data["cv2"])
        log(f"{name} trainer: {TRAIN_IMAGES} "
            + ("image/doodle pairs" if doodle else "images")
            + (f" with one-hot labels of {cond_dim}" if labels is not None
               else "")
            + f" {img}x{img} as .{data['ext']}, "
            + ("np.load in place of the cv2 decode" if cv2 is None
               else "the dataset's cv2 decode"))
        out_dir = os.path.join(tmp, "out")
        config = dict(train_config(out_dir, data_path, cfg, img), **extra)
        with decoders(cv2):
            zero_counts(counters)
            t0 = time.monotonic()
            summary = loop.run_training(spec, config, device=dev,
                                        num_devices=1,
                                        max_steps=TRAIN_STEPS)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            launches = read_counts(counters)

        check_launches(f"{name} trainer ({TRAIN_STEPS} steps of {accum} "
                       f"U-Net calls, one preview of {1000 // DDIM_STEP + 1})",
                       launches, expected_train_launches(
                           cfg, TRAIN_STEPS * accum, streaming))
        with open(os.path.join(out_dir, f"{spec.project_name}.log")) as f:
            lines = f.read().splitlines()
        losses = [float(line.split("Diffusion: ")[1].split(" ")[0])
                  for line in lines if "Cum. Steps:" in line]
        if (summary["global_steps"] != TRAIN_STEPS
                or len(losses) != TRAIN_STEPS
                or not all(math.isfinite(v) for v in losses)):
            raise AssertionError(f"{name} trainer: {summary['global_steps']} "
                                 f"steps, running mean losses {losses}")
        previews = [line for line in lines
                    if "Preview sampling failed" in line]
        grids = ["diffusion_plot_0.jpg"] + (["label_plot.jpg"] if doodle
                                            else [])
        plotted = [os.path.exists(os.path.join(out_dir, "plots", g))
                   for g in grids]
        if previews or plotted != [cv2 is not None] * len(grids):
            raise AssertionError(f"{name} trainer: preview failed: "
                                 f"{previews}, grids {grids} written "
                                 f"{plotted}")
        names = sorted(os.listdir(os.path.join(out_dir, "checkpoint")))
        want = sorted(f"{k}_{s}.pt" for k in ("config", "diffusion")
                      for s in (0, TRAIN_STEPS))
        if names != want:
            raise AssertionError(f"{name} trainer: checkpoints {names}")

        # The step-0 checkpoint into a fresh model and Adam: strict keys,
        # the one step taken, its moments; with ema_decay, both
        # checkpoints' "ema" weights load strictly too.
        net = UNet.from_config(config)
        if "ema_decay" in extra:
            for at in (0, TRAIN_STEPS):
                ck = torch.load(os.path.join(out_dir, "checkpoint",
                                             f"diffusion_{at}.pt"),
                                map_location="cpu")
                net.load_state_dict(ck["ema"], strict=True)
            log(f"{name} trainer: the step-0 and step-{TRAIN_STEPS} "
                f"checkpoints' ema weights reload strictly")
            del ck
        ckpt = torch.load(os.path.join(out_dir, "checkpoint",
                                       "diffusion_0.pt"), map_location="cpu")
        net.load_state_dict(ckpt["model"], strict=True)
        opt, _ = make_optimizer(net.parameters(), config["diffusion_lr"],
                                config["lr_steps"])
        count = load_optimizer_from_checkpoint(ckpt, opt)
        moved = 0
        for idx, p in enumerate(net.parameters()):
            for key in ("exp_avg", "exp_avg_sq"):
                if not torch.equal(opt.state[p][key],
                                   ckpt["optimizer"]["state"][idx][key]):
                    raise AssertionError(f"{name} trainer: Adam {key} {idx} "
                                         "did not reload")
            moved += int(opt.state[p]["exp_avg"].abs().max().item() > 0)
        if count != 1 or moved == 0:
            raise AssertionError(f"{name} trainer: step-0 checkpoint count "
                                 f"{count}, {moved} non-zero moments")
        log(f"{name} trainer: step-0 checkpoint reloads strictly "
            f"({len(net.state_dict())} tensors, Adam count {count}, {moved} "
            "parameters with non-zero first moments)")
        del net, opt, ckpt

        # Rate: the median of the loop's step intervals past the first,
        # which holds the step-0 checkpoint and preview. The median, since
        # the last interval is short whenever the host reads the second-to-
        # last loss after the last step has already finished.
        times = sorted(summary["step_times"][1:])
        sps = 1.0 / times[len(times) // 2]
        state = summary["state"]
        schedule = make_schedule("LINEAR", max_noise_step=1000, device=dev)
        step_fn = make_train_step(
            schedule, objective=(Objective.V if extra.get("objective") == "V"
                                 else spec.objective),
            max_actual_noise_step=1000, flip_imgs=spec.has_flip,
            cond_t=config.get("cond_t"), lr_dim=config.get("lr_dim"),
            grad_accum_steps=accum,
            cfg_drop_prob=extra.get("cfg_drop_prob", 0.0),
            ema_decay=extra.get("ema_decay"),
            min_snr_gamma=extra.get("min_snr_gamma"))
        batch = {"image": images[:BATCH]}
        if doodle:
            batch["cond_img"] = conds[:BATCH]
        if labels is not None:
            batch["labels"] = labels[:BATCH]
        batch = {k: torch.from_numpy(v.reshape(
            (accum, BATCH // accum) + v.shape[1:]) if accum > 1 else v
        ).to(dev) for k, v in batch.items()}
        gen = torch.Generator(device=dev).manual_seed(4)
        split = device_breakdown(torch, lambda: step_fn(state, batch, gen))
    log(f"{name} trainer: {TRAIN_STEPS} steps in {wall:.2f} s (with the "
        f"step-0 checkpoint, preview and the final checkpoint); median "
        f"interval of steps 2-{TRAIN_STEPS}: {1e3 / sps:.1f} ms, {sps:.3f} "
        f"steps/s, {sps * BATCH:.1f} img/s; "
        f"running mean losses {[round(v, 5) for v in losses]}")
    if split is None:
        log(f"{name} train step device breakdown: not measured (the profiler "
            "trace holds no device time)")
    else:
        log(f"{name} train step device breakdown (profiler): "
            f"{split['total_ms']:.3f} ms in {split['launches']} kernel "
            "launches; " + ", ".join(
                f"{k} {v:.3f} ms" for k, v in
                sorted(split["families"].items(), key=lambda kv: -kv[1])))
        for k in split["top"]:
            log(f"  {k['ms']:8.3f} ms  x{k['count']:<4d} {k['name']}")
    del state, summary
    torch.cuda.empty_cache()
    return launches, dict(steps_per_s=sps, img_per_s=sps * BATCH,
                          run_seconds=wall, losses=losses,
                          device_breakdown=split)


# --------------------------------------------------------------- phase 8

def expected_remat_launches(cfg, streaming):
    """Launches of one forward+backward with "remat": the backward replays
    each checkpointed block's forward twice (the block's checkpoint
    replays it to reach the nested checkpoints' inputs, then each nested
    checkpoint replays its own sublayer), so every forward kernel runs
    three times; dV, dK and dQ once per streaming block, as without."""
    out = expected_grad_launches(cfg, 1, streaming)
    forward = expected_launches(cfg, 1, streaming)
    for kernel, n in forward.items():
        out[kernel] += 2 * n
    return out


def remat_phase(torch, counters):
    """The SR U-Net (256x256, bf16, batch 16, kernels on) with "remat"
    against without: one forward and backward each under the trainers'
    loss, the same weights and inputs; the loss equal, the whole bf16
    gradient within GRAD_TOL, each run's launches held (`expected_remat_
    launches`), its peak device memory and time; then the remat step at
    batch 64, the batch sdm_tpu's remat exists for. Returns the remat
    run's launches and a report."""
    from sdm_tpu_torch.models import UNet
    dev = torch.device("cuda")
    report = {}

    def inputs(n, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn((n, SR_IMG, SR_IMG, SR["in_channel"]),
                        generator=gen, device=dev)
        target = torch.randn((n, SR_IMG, SR_IMG, SR["out_channel"]),
                             generator=gen, device=dev)
        t = torch.randint(1, 1000, (n,), generator=gen, device=dev)
        return x, target, t

    def fwd_bwd(net, x, target, t):
        net.zero_grad(set_to_none=True)
        loss = torch.mean(torch.square(net(x, t).float() - target))
        loss.backward()
        return loss.detach()

    torch.manual_seed(0)
    nets = {on: UNet(**SR, dtype=torch.bfloat16, remat=on) for on in
            (False, True)}
    nets[True].load_state_dict(nets[False].state_dict())
    nets = {on: n.to(dev, memory_format=torch.channels_last)
            for on, n in nets.items()}
    x, target, t = inputs(BATCH, 8)
    launches = {}
    for on, net in nets.items():
        name = "remat" if on else "no remat"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(counters)
        loss = fwd_bwd(net, x, target, t)
        torch.cuda.synchronize()
        launches[on] = read_counts(counters)
        peak = torch.cuda.max_memory_allocated()
        check_launches(f"sr U-Net forward and backward, {name}",
                       launches[on],
                       expected_remat_launches(SR, 1) if on
                       else expected_grad_launches(SR, 1, 1))
        ms = time_ms(lambda: fwd_bwd(net, x, target, t), 2)
        report[name] = dict(loss=loss.item(), peak_bytes=peak, ms=ms)
        log(f"sr U-Net bf16 batch {BATCH} forward+backward, {name}: loss "
            f"{loss.item():.6f}, peak device memory {peak / 2 ** 30:.3f} "
            f"GiB, {ms:.2f} ms")
    if report["remat"]["loss"] != report["no remat"]["loss"]:
        raise AssertionError(f"remat changed the loss: {report}")
    pairs = [(p.grad.float(), q.grad.float()) for p, q in
             zip(nets[True].parameters(), nets[False].parameters())
             if q.grad is not None]
    whole = (math.sqrt(sum((a - b).norm().item() ** 2 for a, b in pairs))
             / math.sqrt(sum(b.norm().item() ** 2 for _, b in pairs)))
    log(f"sr U-Net gradients, remat vs not: whole normwise rel {whole:.3e} "
        f"(tol {GRAD_TOL['bfloat16']}); launches per step "
        f"{launches[False]['fused_adagn']} -> {launches[True]['fused_adagn']} "
        f"AdaGN, {launches[False]['streaming_stats']} -> "
        f"{launches[True]['streaming_stats']} streaming stats: the backward "
        "replays every checkpointed sublayer twice (the block's checkpoint, "
        "then the sublayer's own nested one)")
    if not whole <= GRAD_TOL["bfloat16"]:
        raise AssertionError(f"remat gradients differ: {whole}")
    report["grad_whole_rel"] = whole
    del pairs, nets[False], x, target, t
    torch.cuda.empty_cache()

    x, target, t = inputs(64, 9)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss = fwd_bwd(nets[True], x, target, t)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    t0 = time.monotonic()
    loss = fwd_bwd(nets[True], x, target, t)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    if not math.isfinite(loss.item()):
        raise AssertionError(f"remat at batch 64: loss {loss.item()}")
    log(f"sr U-Net bf16 batch 64 forward+backward with remat: peak device "
        f"memory {peak / 2 ** 30:.3f} GiB, {wall * 1e3:.1f} ms (wall, "
        f"synchronized), loss {loss.item():.6f}")
    report["remat batch 64"] = dict(peak_bytes=peak, ms=wall * 1e3)
    del nets, x, target, t
    torch.cuda.empty_cache()
    return launches[True], report


# --------------------------------------------------------------- phase 9

def run_trainer(torch, counters, out_dir, data, extra, steps, wrap=None):
    """run_training(BASE_SPEC) of the flagship on `data` (write_dataset)
    for `steps` steps with `extra` config keys, the launch counters zeroed
    just before and read just after. `wrap(step)` may wrap the train step.
    Returns (summary, launches, log lines)."""
    from sdm_tpu_torch.train import loop
    config = dict(train_config(out_dir, data["path"], FLAGSHIP, IMG),
                  max_epoch=10, **extra)
    make = loop.make_train_step
    if wrap is not None:
        loop.make_train_step = lambda *a, **k: wrap(make(*a, **k))
    try:
        with decoders(data["cv2"]):
            zero_counts(counters)
            summary = loop.run_training(loop.BASE_SPEC, config,
                                        device=torch.device("cuda"),
                                        num_devices=1, max_steps=steps)
            torch.cuda.synchronize()
            launches = read_counts(counters)
    finally:
        loop.make_train_step = make
    with open(os.path.join(out_dir, "Diffusion.log")) as f:
        lines = f.read().splitlines()
    return summary, launches, lines


def step_losses(lines):
    return [float(line.split("Diffusion: ")[1].split(" ")[0])
            for line in lines if "Cum. Steps:" in line]


def loop_phase(torch, counters):
    """The base trainer's loop options on the flagship (128x128, bf16,
    batch 16, the 96 seeded images): "device_dataset" with steps_per_call 4
    for 8 steps (the resident data's line, 8 step lines, step-cadence
    checkpoints at the chunk boundaries 4 and 8, launches held); then 24
    steps fused and 24 per step, checkpoints off, for the median step
    interval and the launches per step of each; then "async_checkpoint":
    the parameters and Adam moments the worker saved at steps 2 and 4
    against synchronous clones taken right after those steps, bit for bit.
    Returns the fused run's launches and a report."""
    from sdm_tpu_torch.diffusion.samplers import ddim_step_list
    report = {}
    preview = len(ddim_step_list(1, 1000, DDIM_STEP))
    with tempfile.TemporaryDirectory() as tmp:
        data = write_dataset(tmp, IMG)
        out = os.path.join(tmp, "fused")
        summary, launches, lines = run_trainer(
            torch, counters, out, data, dict(
                device_dataset=True, steps_per_call=4, checkpoint_steps=4),
            8)
        losses = step_losses(lines)
        resident = [line for line in lines
                    if "Device-resident dataset" in line]
        names = sorted(os.listdir(os.path.join(out, "checkpoint")))
        epoch_ends = list(range(TRAIN_IMAGES // BATCH, 9,
                                TRAIN_IMAGES // BATCH))
        want = sorted(f"{k}_{s}.pt" for k in ("config", "diffusion")
                      for s in {4, 8, *epoch_ends})
        mib = TRAIN_IMAGES * IMG * IMG * 3 / 2 ** 20
        log(f"fused base trainer: {resident}; losses {losses}; "
            f"checkpoints {names}")
        if (summary["global_steps"] != 8 or len(losses) != 8
                or not all(math.isfinite(v) for v in losses)
                or len(resident) != 1
                or f"{TRAIN_IMAGES} rows ({mib:.1f} MiB)" not in resident[0]
                or names != want
                or sum(re.search(r" Epoch: \d+ \| Diffusion", line)
                       is not None for line in lines) != len(epoch_ends)):
            raise AssertionError(f"fused base trainer: {summary['global_steps']}"
                                 f" steps, {resident}, {names}")
        # Previews at the chunk boundaries 4 and 8 and at the end.
        check_launches("fused base trainer (8 steps, 3 previews of "
                       f"{preview} U-Net calls)", launches,
                       {k: n + 3 * expected_launches(FLAGSHIP, preview, 0)[k]
                        for k, n in expected_grad_launches(FLAGSHIP, 8,
                                                           0).items()})
        report["fused"] = dict(losses=losses, checkpoints=names)

        # The rate of each path, checkpoints off (one at the end, and the
        # per-step path's at step 0, each with a preview).
        quiet = dict(checkpoint_steps=10 ** 6, epoch_checkpoint_every=10 ** 6)
        for name, extra in (("per-step", {}),
                            ("fused", dict(device_dataset=True,
                                           steps_per_call=4))):
            summary, runs, _ = run_trainer(
                torch, counters, os.path.join(tmp, f"rate_{name}"), data,
                dict(quiet, **extra), 24)
            times = sorted(summary["step_times"])
            median = times[len(times) // 2]
            per_step = {k: (n - expected_launches(FLAGSHIP, preview, 0)[k])
                        / 24 for k, n in runs.items()}
            log(f"{name} base trainer, 24 steps: median step interval "
                f"{median * 1e3:.2f} ms ({len(times)} intervals), launches "
                f"per step {per_step['fused_adagn']:.0f} AdaGN, "
                f"{per_step['fused_attention']:.0f} attention, "
                f"{per_step['linear']:.0f} linear")
            report[f"{name} rate"] = dict(median_step_ms=median * 1e3,
                                          launches_per_step=per_step)

        # Async checkpoints: clones taken right after the steps that the
        # checkpoints at 2 and 4 save, synchronously.
        clones = {}

        def wrap(step):
            def wrapped(state, batch, generator=None):
                metrics = step(state, batch, generator)
                if state.step - 1 in (2, 4):
                    torch.cuda.synchronize()
                    opt = state.optimizer
                    clones[state.step - 1] = dict(
                        model={k: v.detach().cpu().clone() for k, v in
                               state.model.state_dict().items()},
                        moments=[(opt.state[p]["exp_avg"].cpu().clone(),
                                  opt.state[p]["exp_avg_sq"].cpu().clone())
                                 for p in state.model.parameters()])
                return metrics
            return wrapped
        out = os.path.join(tmp, "async")
        t0 = time.monotonic()
        summary, _, lines = run_trainer(
            torch, counters, out, data, dict(async_checkpoint=True,
                                             checkpoint_steps=2), 6, wrap)
        wall = time.monotonic() - t0
        for at, clone in sorted(clones.items()):
            ckpt = torch.load(os.path.join(out, "checkpoint",
                                           f"diffusion_{at}.pt"),
                              map_location="cpu")
            same = all(torch.equal(ckpt["model"][k], v)
                       for k, v in clone["model"].items())
            same_m = all(
                torch.equal(ckpt["optimizer"]["state"][i]["exp_avg"], m)
                and torch.equal(ckpt["optimizer"]["state"][i]["exp_avg_sq"],
                                v)
                for i, (m, v) in enumerate(clone["moments"]))
            log(f"async checkpoint at step {at}: parameters "
                f"{'equal' if same else 'DIFFER from'} the synchronous "
                f"clone, Adam moments {'equal' if same_m else 'DIFFER'}")
            if not (same and same_m):
                raise AssertionError(f"async checkpoint {at} is not the "
                                     "step's state")
        if sorted(clones) != [2, 4] or summary["global_steps"] != 6:
            raise AssertionError(f"async run: clones {sorted(clones)}")
        plots = sorted(os.listdir(os.path.join(out, "plots")))
        log(f"async checkpoint run: 6 steps in {wall:.2f} s, previews "
            f"{plots}")
        report["async"] = dict(seconds=wall, previews=plots)
    torch.cuda.empty_cache()
    return launches, report


# --------------------------------------------------------------- phase 10

DISTILL_STEPS = 4


def distill_phase(torch, counters):
    """Progressive distillation of the flagship (128x128, bf16, batch 16):
    one step's loss and student gradients kernels on against off with
    injected rows and eps (GRAD_TOL), its launches (3 U-Net forwards: the
    teacher's two and the student's) held; its device time (profiler) and
    median wall time; then `cli/distill_diffusion.py` for 2 phases of
    DISTILL_STEPS steps from a saved teacher, the dataset loaded per step
    and device-resident, launches held; both runs' students reload
    strictly, and the last one exports and samples through the generator
    at its step size. Returns the CLI runs' launches and a report."""
    import copy

    import numpy as np
    from sdm_tpu_torch.cli import distill_diffusion
    from sdm_tpu_torch.cli.generate_images_diffusion import \
        generate_images_diffusion
    from sdm_tpu_torch.diffusion.samplers import ddim_step_list
    from sdm_tpu_torch.io.checkpoint import diffusion_checkpoint_dict
    from sdm_tpu_torch.models import UNet
    from sdm_tpu_torch.ops.schedules import make_schedule
    from sdm_tpu_torch.train.distill import make_distill_step
    from sdm_tpu_torch.train.step import create_train_state, make_optimizer
    dev = torch.device("cuda")
    report = {}
    schedule = make_schedule("LINEAR", max_noise_step=1000, device=dev)
    step_list = ddim_step_list(1, 1000, 2 * DDIM_STEP)
    step = make_distill_step(schedule, step_list=step_list)
    gen = torch.Generator(device=dev).manual_seed(10)
    batch = {"image": torch.randint(0, 256, (BATCH, IMG, IMG, 3),
                                    generator=gen, device=dev,
                                    dtype=torch.uint8),
             "row": torch.randint(0, len(step_list), (BATCH,), generator=gen,
                                  device=dev),
             "eps": torch.randn((BATCH, IMG, IMG, 3), generator=gen,
                                device=dev)}
    torch.manual_seed(0)
    teachers = {on: UNet(**FLAGSHIP, dtype=torch.bfloat16, use_kernels=on)
                for on in (True, False)}
    teachers[False].load_state_dict(teachers[True].state_dict())
    teachers = {on: n.to(dev, memory_format=torch.channels_last)
                .requires_grad_(False) for on, n in teachers.items()}
    students = {on: copy.deepcopy(n).requires_grad_(True)
                for on, n in teachers.items()}
    out = {}
    for on in (True, False):
        zero_counts(counters)
        loss = step.loss_fn(students[on], teachers[on], batch, None)
        loss.backward()
        torch.cuda.synchronize()
        out[on] = (loss.item(), read_counts(counters))
    check_launches("distill step, kernels on (3 U-Net forwards, 1 "
                   "backward)", out[True][1],
                   expected_launches(FLAGSHIP, 3, 0))
    pairs = [(p.grad.float(), q.grad.float()) for p, q in
             zip(students[True].parameters(), students[False].parameters())
             if q.grad is not None]
    whole = (math.sqrt(sum((a - b).norm().item() ** 2 for a, b in pairs))
             / math.sqrt(sum(b.norm().item() ** 2 for _, b in pairs)))
    loss_rel = abs(out[True][0] - out[False][0]) / abs(out[False][0])
    log(f"distill step kernels vs plain: loss {out[True][0]:.6f} vs "
        f"{out[False][0]:.6f} (rel {loss_rel:.3e}), student gradients whole "
        f"normwise rel {whole:.3e} (tol {GRAD_TOL['bfloat16']})")
    if not (whole <= GRAD_TOL["bfloat16"]
            and loss_rel <= GRAD_TOL["bfloat16"]):
        raise AssertionError(f"distill step kernels vs plain: loss rel "
                             f"{loss_rel}, gradients {whole}")
    report.update(loss_rel=loss_rel, grad_whole_rel=whole)
    del pairs, teachers[False], students[False]

    # Time: a whole step (Adam included) on the kernels path.
    student = students[True]
    opt, sched = make_optimizer(student.parameters(), 2e-5, 100_000)
    state = create_train_state(student, opt, sched)
    full = {"image": batch["image"]}

    def one():
        return step(state, teachers[True], full, gen)
    split = device_breakdown(torch, one)
    walls = []
    for _ in range(5):
        t0 = time.monotonic()
        one()
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
    median = sorted(walls)[2]
    if split is None:
        log("distill step device time: not measured (the profiler trace "
            "holds no device time)")
    else:
        log(f"distill step device breakdown (profiler): "
            f"{split['total_ms']:.3f} ms in {split['launches']} kernel "
            "launches; " + ", ".join(
                f"{k} {v:.3f} ms" for k, v in
                sorted(split["families"].items(), key=lambda kv: -kv[1])))
    log(f"distill step: median wall {median * 1e3:.2f} ms of 5 "
        "(synchronized)")
    report.update(device_breakdown=split, median_step_ms=median * 1e3)
    del state, opt, student, students, teachers, batch, full
    torch.cuda.empty_cache()

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = write_dataset(tmp, IMG)
        torch.manual_seed(0)
        teacher = os.path.join(tmp, "teacher.pt")
        fresh = UNet(**FLAGSHIP)
        torch.save(diffusion_checkpoint_dict(fresh), teacher)
        students_written = []
        for resident in (False, True):
            out_dir = os.path.join(tmp, f"distill_{int(resident)}")
            os.makedirs(out_dir)
            cfg_path = os.path.join(tmp, f"distill_{int(resident)}.json")
            with open(cfg_path, "w") as f:
                json.dump(dict(train_config(out_dir, data["path"], FLAGSHIP,
                                            IMG), device_dataset=resident),
                          f)
            with decoders(data["cv2"]):
                zero_counts(counters)
                t0 = time.monotonic()
                res = distill_diffusion.run(
                    ["-c", cfg_path, "--teacher-checkpoint", teacher,
                     "--phases", "2", "--steps-per-phase",
                     str(DISTILL_STEPS), "--num-devices", "1"])
                torch.cuda.synchronize()
                wall = time.monotonic() - t0
                launches[resident] = read_counts(counters)
            check_launches(f"distill CLI, device_dataset {resident} (2 x "
                           f"{DISTILL_STEPS} steps of 3 forwards)",
                           launches[resident], expected_launches(
                               FLAGSHIP, 3 * 2 * DISTILL_STEPS, 0))
            names = sorted(os.listdir(os.path.join(out_dir, "checkpoint")))
            want = [f"distilled_ss{2 * DDIM_STEP}_{DISTILL_STEPS}.pt",
                    f"distilled_ss{4 * DDIM_STEP}_{2 * DISTILL_STEPS}.pt"]
            if (names != sorted(want)
                    or res["phase_step_sizes"] != [2 * DDIM_STEP,
                                                   4 * DDIM_STEP]
                    or not all(math.isfinite(v)
                               for v in res["phase_losses"])):
                raise AssertionError(f"distill CLI: {names}, {res}")
            for name in names:
                ck = torch.load(os.path.join(out_dir, "checkpoint", name),
                                map_location="cpu")
                fresh.load_state_dict(ck["model"], strict=True)
            log(f"distill CLI, device_dataset {resident}: {names} in "
                f"{wall:.2f} s, phase losses {res['phase_losses']}; both "
                "students reload strictly")
            report[f"cli device_dataset {resident}"] = dict(
                seconds=wall, phase_losses=res["phase_losses"])
            students_written.append(os.path.join(out_dir, "checkpoint",
                                                 want[-1]))

        # The last student, exported, sampled at its own step size.
        from sdm_tpu_torch.cli.export_models import export_bundle
        train = train_config(tmp, data["path"], FLAGSHIP, IMG)
        bundle = export_bundle("student", tmp, img_c=3, img_h=IMG, img_w=IMG,
                               model_type="BASE",
                               entries=[(train, students_written[-1])])
        calls = len(ddim_step_list(1, 1000, 4 * DDIM_STEP))
        zero_counts(counters)
        t0 = time.monotonic()
        images = generate_images_diffusion(
            ["-c", os.path.join(bundle, "config.json"), "-n", str(BATCH),
             "--diff_alg", "ddim", "--ddim_step_size", str(4 * DDIM_STEP),
             "--dtype", "bfloat16", "-s", "0"], log=lambda *a, **k: None,
            save_locally=False)
        wall = time.monotonic() - t0
        launches["student generated"] = read_counts(counters)
        check_launches(f"distilled student generated ({calls} U-Net calls)",
                       launches["student generated"],
                       expected_launches(FLAGSHIP, calls, 0))
        if images.shape != (BATCH, IMG, IMG, 3) or \
                not np.isfinite(images).all():
            raise AssertionError(f"distilled student: images {images.shape}")
        log(f"distilled student (step size {4 * DDIM_STEP}, {calls} calls) "
            f"generated {BATCH} images in {wall:.3f} s (bundle load "
            "included)")
        report["student generated"] = dict(seconds=wall, calls=calls)
    torch.cuda.empty_cache()
    total = {k: sum(run[k] for run in launches.values())
             for k in launches[True]}
    return total, report


# --------------------------------------------------------------- phase 11

FEATURE_TOL = {"randconv": 1e-2, "pixel": 1e-5}


def eval_phase(torch, counters):
    """Sample-quality evaluation: the randconv and pixel features of 64
    seeded images on the card against the port on the CPU (normwise,
    FEATURE_TOL: randconv's four bf16 convs and swishes round in cuDNN's
    order there and oneDNN's here), their extraction time; FID and KID of
    the set against itself (FID 0; KID within a tenth of the dimmed
    copy's) and against a dimmed copy; then `cli/evaluate_samples.py --gen-config` on an
    exported flagship bundle (bf16, DDIM step 20, 16 images) against 16
    real images, launches held. Returns its launches and a report."""
    import numpy as np
    from sdm_tpu_torch.cli.evaluate_samples import evaluate_samples
    from sdm_tpu_torch.eval import fid, make_feature_extractor
    report = {}
    x = np.random.default_rng(11).uniform(
        -1, 1, (64, IMG, IMG, 3)).astype(np.float32)
    for spec in ("randconv", "pixel"):
        f_gpu, name = make_feature_extractor(spec, device="cuda")
        f_cpu, _ = make_feature_extractor(spec, device="cpu")
        f_gpu(x)                         # warm-up: cuDNN plans, the build
        torch.cuda.synchronize()
        t0 = time.monotonic()
        got = f_gpu(x)
        secs = time.monotonic() - t0
        want = f_cpu(x)
        rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        log(f"{name} features of 64 images {IMG}x{IMG}: card vs CPU "
            f"normwise rel {rel:.3e} (tol {FEATURE_TOL[spec]}); extraction "
            f"{secs * 1e3:.2f} ms on the card (wall, to host)")
        if got.shape != want.shape or not rel <= FEATURE_TOL[spec]:
            raise AssertionError(f"{name} features: {got.shape} rel {rel}")
        self_fid = fid.frechet_from_features(got, got)
        self_kid = fid.kernel_distance(got, got)[0]
        dim = f_gpu(np.clip(0.5 * x + 0.2, -1, 1))
        other = (fid.frechet_from_features(got, dim),
                 fid.kernel_distance(got, dim)[0])
        log(f"{name}: the set against itself FID {self_fid:.3e}, KID "
            f"{self_kid:.3e}; against a dimmed copy FID {other[0]:.4f}, KID "
            f"{other[1]:.4e}")
        # FID of a set against itself is 0 (clamped at 0); KID's unbiased
        # estimator reads a small negative value there (the within-set
        # terms drop their diagonals, the cross term keeps it), so it is
        # held to a tenth of the dimmed copy's.
        if not (self_fid <= 1e-9 and other[0] > 1e-6
                and abs(self_kid) <= 0.1 * other[1]):
            raise AssertionError(f"{name}: self FID {self_fid}, KID "
                                 f"{self_kid}; other {other}")
        report[name] = dict(rel_err_vs_cpu=rel, extract_ms=secs * 1e3,
                            self_fid=self_fid, self_kid=self_kid,
                            dimmed_fid=other[0], dimmed_kid=other[1])

    calls = 1000 // DDIM_STEP + 1
    with tempfile.TemporaryDirectory() as tmp:
        bundle = _export(torch, tmp, "flagship", FLAGSHIP, IMG, "BASE")
        real = os.path.join(tmp, "real")
        os.makedirs(real)
        data = write_dataset(real, IMG, n=BATCH, seed=12)
        with decoders(data["cv2"]):
            zero_counts(counters)
            t0 = time.monotonic()
            res = evaluate_samples(
                ["--real-path", data["path"], "--gen-config", bundle,
                 "-n", str(BATCH), "--gen-batch", str(BATCH), "--gen-args",
                 f"--diff_alg ddim --ddim_step_size {DDIM_STEP} "
                 "--dtype bfloat16", "--out", os.path.join(tmp, "m.json")]
                + (["--save-gen-grid", os.path.join(tmp, "grid.jpg")]
                   if data["cv2"] is not None else []),
                log=lambda *a, **k: None)
            wall = time.monotonic() - t0
            launches = read_counts(counters)
        check_launches(f"evaluate_samples --gen-config ({calls} U-Net "
                       "calls)", launches, expected_launches(FLAGSHIP, calls,
                                                             0))
        if (res["n_generated"] != BATCH or res["n_real"] != BATCH
                or not math.isfinite(res["fid"])
                or not math.isfinite(res["kid"])):
            raise AssertionError(f"evaluate_samples: {res}")
        log(f"evaluate_samples --gen-config: {res} in {wall:.2f} s "
            "(bundle load, sampling and both feature passes)")
        report["cli"] = dict(result=res, seconds=wall)
    torch.cuda.empty_cache()
    return launches, report


# --------------------------------------------------------------- phase 12

def _add_counts(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def _params_rel(a, b):
    """Normwise distance of two state dicts over all their tensors."""
    num = sum(float((a[k].float() - b[k].float()).norm()) ** 2 for k in b)
    den = sum(float(b[k].float().norm()) ** 2 for k in b)
    return math.sqrt(num / max(den, 1e-30))


def _seeded_batch(torch, img, seed, dev):
    """A seeded training batch at `img` (uint8 images, injected t and eps),
    batch 16, on `dev`."""
    gen = torch.Generator().manual_seed(seed)
    batch = {"image": torch.randint(0, 256, (BATCH, img, img, 3),
                                    generator=gen, dtype=torch.uint8),
             "t": torch.randint(1, 1000, (BATCH,), generator=gen),
             "eps": torch.randn((BATCH, img, img, 3), generator=gen)}
    return {k: v.to(dev) for k, v in batch.items()}


def _grads(net):
    return {n: p.grad.float().clone() for n, p in net.named_parameters()
            if p.grad is not None}


def _grad_rel(got, want):
    """Whole normwise distance of two gradient dicts (the same names)."""
    if set(got) != set(want):
        raise AssertionError(f"gradient sets differ: {set(got) ^ set(want)}")
    return math.sqrt(sum(float((got[n] - g).norm()) ** 2
                         for n, g in want.items())
                     / sum(float(g.norm()) ** 2 for g in want.values()))


def parallel_phase(torch, counters):
    """The data-parallel paths (see the module docstring, phase 12) on one
    card: (a) the flagship base trainer through run_training in a one-rank
    NCCL group (DDP's reducer) against the same seeded run without one;
    (b) one SR train step under FSDP2 at one rank against the unwrapped
    U-Net; (c) the two-entry flagship ensemble with --pipeline 2 against
    the sequential ensemble; (d) with two or more cards, a two-rank
    --num-devices 2 base run and the engine at num_devices=2. Returns the
    phase's launches (a, b and c together) and a report."""
    import numpy as np
    from sdm_tpu_torch.cli.generate_images_diffusion import \
        generate_images_diffusion
    from sdm_tpu_torch.diffusion.samplers import ddim_step_list
    from sdm_tpu_torch.enums import Objective
    from sdm_tpu_torch.models import UNet
    from sdm_tpu_torch.ops.schedules import make_schedule
    from sdm_tpu_torch.parallel import fsdp, multihost as mh
    from sdm_tpu_torch.parallel.mesh import make_mesh
    from sdm_tpu_torch.train.step import (create_train_state, make_optimizer,
                                          make_train_step)
    dev = torch.device("cuda", 0)
    total, report = {}, {}
    preview = len(ddim_step_list(1, 1000, DDIM_STEP))
    with tempfile.TemporaryDirectory() as tmp:
        data = write_dataset(tmp, IMG)
        # (a) The same seeded run without a group, then in a one-rank NCCL
        # group, where the loop wraps the U-Net in DDP.
        runs = {}
        for name in ("plain", "ddp"):
            if name == "ddp":
                mh.init_group(dev, init_method="file://" + os.path.join(
                    tmp, "rendezvous"), world_size=1, global_rank=0)
            summary, launches, lines = run_trainer(
                torch, counters, os.path.join(tmp, name), data, {},
                TRAIN_STEPS)
            times = sorted(summary["step_times"])
            net = summary["state"].model
            runs[name] = dict(
                losses=step_losses(lines), launches=launches,
                median_ms=times[len(times) // 2] * 1e3,
                wrapped=type(net).__name__,
                params={k: v.detach().clone() for k, v in
                        getattr(net, "module", net).state_dict().items()})
            del summary
        plain, ddp = runs["plain"], runs["ddp"]
        rel = _params_rel(ddp["params"], plain["params"])
        equal = all(torch.equal(ddp["params"][k], v)
                    for k, v in plain["params"].items())
        log(f"parallel (a): base trainer, {TRAIN_STEPS} steps, in a "
            f"one-rank NCCL group ({ddp['wrapped']}) vs without: losses "
            f"{ddp['losses']} vs {plain['losses']}; final parameters "
            f"normwise rel {rel:.3e} ({'equal to the bit' if equal else 'not bit-equal'}); "
            f"median step {ddp['median_ms']:.2f} ms under DDP, "
            f"{plain['median_ms']:.2f} ms plain")
        if (ddp["wrapped"] != "DistributedDataParallel"
                or len(ddp["losses"]) != TRAIN_STEPS
                or not np.allclose(ddp["losses"], plain["losses"],
                                   rtol=1e-6, atol=0) or not rel <= 1e-6):
            raise AssertionError(f"parallel (a): DDP run differs "
                                 f"({ddp['wrapped']}, {rel})")
        expect = expected_train_launches(FLAGSHIP, TRAIN_STEPS, 0)
        check_launches(f"parallel (a): DDP base trainer ({TRAIN_STEPS} "
                       f"steps, a preview of {preview} calls)",
                       ddp["launches"], expect)
        check_launches("parallel (a): plain base trainer", plain["launches"],
                       expect)
        _add_counts(total, ddp["launches"])
        report["ddp"] = dict(
            losses=ddp["losses"], plain_losses=plain["losses"],
            params_rel=rel, params_equal=equal,
            median_step_ms=ddp["median_ms"],
            plain_median_step_ms=plain["median_ms"])
        del runs, plain, ddp
        torch.cuda.empty_cache()

        # (b) One SR step under FSDP2 at one rank against the unwrapped
        # U-Net: gradients, launches, step time and peak memory.
        batch = _seeded_batch(torch, SR_IMG, 11, dev)
        schedule = make_schedule("LINEAR", beta_1=5e-3, beta_T=9e-3,
                                 max_noise_step=1000, device=dev)
        step = make_train_step(schedule, objective=Objective.RESIDUAL_X0,
                               cond_t=SR_COND_T, lr_dim=SR_IMG // 2)
        sides = {}
        for name in ("unwrapped", "fsdp"):
            torch.manual_seed(0)
            net = UNet(**SR, dtype=torch.bfloat16)
            if name == "fsdp":
                net = fsdp.shard_model(net.to(dev), make_mesh("cuda"))
            else:
                net = net.to(dev, memory_format=torch.channels_last)
            optimizer, lr_schedule = make_optimizer(net.parameters(), 2e-5,
                                                    100_000)
            state = create_train_state(net, optimizer, lr_schedule)
            # Gradients of one forward and backward, launches counted.
            net.zero_grad(set_to_none=True)
            zero_counts(counters)
            step.loss_fn(net, batch, None).backward()
            torch.cuda.synchronize()
            launches = read_counts(counters)
            grads = {n: (p.grad.full_tensor() if hasattr(p.grad,
                                                         "full_tensor")
                         else p.grad).float().clone()
                     for n, p in net.named_parameters()
                     if p.grad is not None}
            # The whole step (Adam included): its time and peak memory.
            step(state, batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = time_ms(lambda: step(state, batch), 3)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            sides[name] = dict(launches=launches, grads=grads, ms=ms,
                               peak_gib=peak,
                               state_bytes=fsdp.state_bytes_per_device(
                                   net, optimizer))
            del net, optimizer, state
            torch.cuda.empty_cache()
        un, fs = sides["unwrapped"], sides["fsdp"]
        whole = _grad_rel(fs["grads"], un["grads"])
        log(f"parallel (b): SR step (batch {BATCH}, bf16) under FSDP2 at "
            f"one rank vs unwrapped: gradients whole normwise rel "
            f"{whole:.3e} (tol {GRAD_TOL['bfloat16']}); step "
            f"{fs['ms']:.2f} ms vs {un['ms']:.2f} ms; peak "
            f"{fs['peak_gib']:.3f} GiB vs {un['peak_gib']:.3f} GiB; state "
            f"bytes per device {fs['state_bytes']} vs {un['state_bytes']}")
        if not whole <= GRAD_TOL["bfloat16"]:
            raise AssertionError(f"parallel (b): FSDP gradients {whole}")
        check_launches("parallel (b): SR forward and backward under FSDP2",
                       fs["launches"], expected_grad_launches(SR, 1, 1))
        _add_counts(total, fs["launches"])
        report["fsdp"] = dict(
            grad_whole_rel=whole, step_ms=fs["ms"], plain_step_ms=un["ms"],
            peak_gib=fs["peak_gib"], plain_peak_gib=un["peak_gib"],
            state_bytes_per_device=fs["state_bytes"],
            plain_state_bytes=un["state_bytes"])
        del sides, un, fs, batch
        torch.distributed.destroy_process_group()
        torch.cuda.empty_cache()

        # (c) The two-entry ensemble, sequential then --pipeline 2.
        config = _export(torch, tmp, "ensemble", FLAGSHIP, IMG, "BASE",
                         ranges=ENSEMBLE)
        args = ["-c", config, "-n", str(BATCH), "--diff_alg", "ddim",
                "--ddim_step_size", str(DDIM_STEP), "--dtype", "bfloat16",
                "-s", "0"]
        calls = sum(len(ddim_step_list(lo, hi, DDIM_STEP))
                    for lo, hi in ENSEMBLE)
        out = {}
        # The pipeline runs each stage's sampler once a microbatch: twice
        # the sequential U-Net calls, each at half the batch.
        for name, extra, micro in (("sequential", [], 1),
                                   ("pipeline", ["--pipeline", "2"], 2)):
            zero_counts(counters)
            t0 = time.monotonic()
            out[name] = generate_images_diffusion(
                args + extra, log=lambda *a, **k: None, save_locally=False)
            wall = time.monotonic() - t0
            launches = read_counts(counters)
            check_launches(f"parallel (c): ensemble, {name} ({micro} x "
                           f"{calls} U-Net calls at batch {BATCH // micro})",
                           launches,
                           expected_launches(FLAGSHIP, micro * calls, 0))
            out[name + "_s"] = wall
            if name == "pipeline":
                _add_counts(total, launches)
        seq, pipe = out["sequential"], out["pipeline"]
        rel = float(np.linalg.norm(pipe - seq) / np.linalg.norm(seq))
        bit = bool(np.array_equal(pipe, seq))
        log(f"parallel (c): --pipeline 2 vs sequential ensemble, {BATCH} "
            f"images bf16: normwise rel {rel:.3e} (tol "
            f"{MODEL_TOL['bfloat16']}; {'equal to the bit' if bit else 'not bit-equal'}); "
            f"{out['pipeline_s']:.3f} s vs {out['sequential_s']:.3f} s")
        if not (pipe.shape == seq.shape and np.isfinite(pipe).all()
                and rel <= MODEL_TOL["bfloat16"]):
            raise AssertionError(f"parallel (c): pipeline images {rel}")
        report["pipeline"] = dict(rel=rel, bit_equal=bit,
                                  seconds=out["pipeline_s"],
                                  sequential_seconds=out["sequential_s"])

        # (d) Two cards, where there are two.
        cards = torch.cuda.device_count()
        if cards < 2:
            log(f"parallel (d): two-card checks skipped: {cards} CUDA "
                "device visible")
            report["two_card"] = dict(skipped=True, devices=cards)
        else:
            report["two_card"] = two_card_checks(torch, tmp, data, config)
    torch.cuda.empty_cache()
    return total, report


def two_card_checks(torch, tmp, data, config):
    """A two-rank --num-devices 2 base run (one process per card) and the
    engine at num_devices=2 against one card."""
    import numpy as np
    from sdm_tpu_torch.serving import SamplerEngine
    from sdm_tpu_torch.train import loop
    cfg = dict(train_config(os.path.join(tmp, "two"), data["path"],
                            FLAGSHIP, IMG), max_epoch=10)
    t0 = time.monotonic()
    with decoders(data["cv2"]):
        summary = loop.run_training(loop.BASE_SPEC, cfg, device="cuda",
                                    num_devices=2, max_steps=TRAIN_STEPS)
    wall = time.monotonic() - t0
    if summary["global_steps"] != TRAIN_STEPS or \
            not math.isfinite(summary["last_loss"]):
        raise AssertionError(f"parallel (d): two-rank run {summary}")
    images = {}
    for n in (1, 2):
        engine = SamplerEngine(config, diff_alg="ddim", step_size=DDIM_STEP,
                               max_batch=BATCH, dtype="bfloat16",
                               num_devices=n, log=log)
        images[n] = engine.generate(BATCH, seed=7)
        del engine
    rel = float(np.linalg.norm(images[2] - images[1])
                / np.linalg.norm(images[1]))
    log(f"parallel (d): --num-devices 2 base run, {TRAIN_STEPS} steps in "
        f"{wall:.2f} s, last loss {summary['last_loss']:.5f}; engine on two "
        f"cards vs one: normwise rel {rel:.3e}")
    if not rel <= MODEL_TOL["bfloat16"]:
        raise AssertionError(f"parallel (d): engine on two cards {rel}")
    return dict(skipped=False, seconds=wall, engine_rel=rel,
                last_loss=summary["last_loss"])


def model_parallel_phase(torch, counters):
    """Tensor parallelism and spatial partitioning (the module docstring,
    phase 13): (a) the flagship's and the SR model's train step with every
    eligible layer tensor-parallel in a one-rank NCCL group against the
    unwrapped U-Net, kernels on (`tp_one_rank_case`); (b) one SR train
    step inside the SP context at one rank against the plain U-Net; (c)
    with two or more cards, the trainers against one card, an SR step's
    peak at sp=2, the SR generator with --sp 2, and the collective bytes
    of a two-card DP and TP step (`model_parallel_cards`). Returns (a)'s
    launches and a report."""
    from sdm_tpu_torch.enums import Objective
    from sdm_tpu_torch.models import UNet
    from sdm_tpu_torch.ops.schedules import make_schedule
    from sdm_tpu_torch.parallel import multihost as mh, sp
    from sdm_tpu_torch.parallel.mesh import make_model_mesh
    from sdm_tpu_torch.train.step import (create_train_state, make_optimizer,
                                          make_train_step)
    dev = torch.device("cuda", 0)
    report = {}
    schedule = make_schedule("LINEAR", beta_1=5e-3, beta_T=9e-3,
                             max_noise_step=1000, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        mh.init_group(dev, init_method="file://" + os.path.join(
            tmp, "rendezvous"), world_size=1, global_rank=0)
        mesh = make_model_mesh(dev.type, 1, 1)
        # (a) The base step, and one SR step (the streaming kernels,
        # forward and backward), every conv and linear column-parallel over
        # a model group of one (tp_min_width 1), against the unwrapped
        # U-Net.
        launches = {}
        for model, cfg, img, objective, streaming, seed in (
                ("flagship", FLAGSHIP, IMG, Objective.EPS, 0, 21),
                ("sr", SR, SR_IMG, Objective.RESIDUAL_X0, 1, 27)):
            report[f"tp_one_rank{'_sr' if streaming else ''}"], got = \
                tp_one_rank_case(torch, counters, mesh, schedule, model, cfg,
                                 img, objective, streaming, seed)
            _add_counts(launches, got)

        # (b) One SR step inside the SP context (a space group of one)
        # against the plain U-Net: gradients, no kernel, peak memory.
        batch = _seeded_batch(torch, SR_IMG, 22, dev)
        shard = sp.SpaceShard(mesh.space_group, 0, 1)
        sides = {}
        for name, space in (("plain", None), ("sp", shard)):
            step = make_train_step(schedule, objective=Objective.RESIDUAL_X0,
                                   cond_t=SR_COND_T, lr_dim=SR_IMG // 2,
                                   space=space)
            torch.manual_seed(0)
            net = UNet(**SR, dtype=torch.bfloat16, use_kernels=False).to(
                dev, memory_format=torch.channels_last)
            optimizer, lr_schedule = make_optimizer(net.parameters(), 2e-5,
                                                    100_000)
            state = create_train_state(net, optimizer, lr_schedule)
            zero_counts(counters)
            with sp.spatial(space):
                loss = step.loss_fn(net, batch, None)
                loss.backward()
            torch.cuda.synchronize()
            n_launch = sum(read_counts(counters).values())
            grads = _grads(net)
            net.zero_grad(set_to_none=True)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.monotonic()
            step(state, batch)
            torch.cuda.synchronize()
            sides[name] = dict(loss=loss.item(), grads=grads,
                               launches=n_launch,
                               step_s=time.monotonic() - t0,
                               peak_gib=torch.cuda.max_memory_allocated()
                               / 2 ** 30)
            del net, optimizer, state, grads
            torch.cuda.empty_cache()
        pl, spr = sides["plain"], sides["sp"]
        whole = _grad_rel(spr["grads"], pl["grads"])
        log(f"model_parallel (b): SR step (batch {BATCH}, bf16) in the SP "
            f"context at one rank vs plain: gradients whole normwise rel "
            f"{whole:.3e} (tol {GRAD_TOL['bfloat16']}); kernel launches "
            f"{spr['launches']} vs {pl['launches']}; peak "
            f"{spr['peak_gib']:.3f} GiB vs {pl['peak_gib']:.3f} GiB; step "
            f"{spr['step_s']:.3f} s vs {pl['step_s']:.3f} s (one run each)")
        if not whole <= GRAD_TOL["bfloat16"] or spr["launches"] or \
                pl["launches"]:
            raise AssertionError(f"model_parallel (b): SP step {whole}, "
                                 f"{spr['launches']} launches")
        report["sp_one_rank"] = dict(
            grad_whole_rel=whole, loss=spr["loss"], plain_loss=pl["loss"],
            peak_gib=spr["peak_gib"], plain_peak_gib=pl["peak_gib"],
            step_s=spr["step_s"], plain_step_s=pl["step_s"])
        del sides, pl, spr, batch
        torch.distributed.destroy_process_group()
        torch.cuda.empty_cache()

        cards = torch.cuda.device_count()
        if cards < 2:
            log(f"model_parallel (c): two-card checks skipped: {cards} CUDA "
                "device visible")
            report["cards"] = dict(skipped=True, devices=cards)
        else:
            report["cards"] = model_parallel_cards(torch, tmp, cards,
                                                   report)
    torch.cuda.empty_cache()
    return launches, report


def tp_one_rank_case(torch, counters, mesh, schedule, model, cfg, img,
                     objective, streaming, seed):
    """Phase 13 (a): one train step of `cfg` (batch 16, bf16, kernels on)
    with every conv and linear column-parallel in `mesh`'s one-rank model
    group against the unwrapped U-Net: the loss within MODEL_TOL, the whole
    gradient within GRAD_TOL, the launches of the forward and backward the
    same as unwrapped (`expected_grad_launches`: on SR the streaming stats,
    apply, dV, dK and dQ among them), the step's ms and peak memory beside
    the unwrapped one's. Returns (a report, the TP side's launches)."""
    from sdm_tpu_torch.models import UNet
    from sdm_tpu_torch.parallel import tp
    from sdm_tpu_torch.train.step import (create_train_state, make_optimizer,
                                          make_train_step)
    dev = torch.device("cuda", 0)
    batch = _seeded_batch(torch, img, seed, dev)
    step = (make_train_step(schedule, objective=objective) if not streaming
            else make_train_step(schedule, objective=objective,
                                 cond_t=SR_COND_T, lr_dim=img // 2))
    sides = {}
    for name in ("unwrapped", "tp"):
        torch.manual_seed(0)
        net = UNet(**cfg, dtype=torch.bfloat16).to(
            dev, memory_format=torch.channels_last)
        names = (tp.shard_model(net, mesh.model_group, min_width=1)
                 if name == "tp" else {})
        optimizer, lr_schedule = make_optimizer(net.parameters(), 2e-5,
                                                100_000)
        state = create_train_state(net, optimizer, lr_schedule)
        net.zero_grad(set_to_none=True)
        zero_counts(counters)
        loss = step.loss_fn(net, batch, None)
        loss.backward()
        torch.cuda.synchronize()
        launches = read_counts(counters)
        grads = _grads(net)
        net.zero_grad(set_to_none=True)
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(lambda: step(state, batch), 3)
        sides[name] = dict(loss=loss.item(), grads=grads, launches=launches,
                           sharded=len(names), ms=ms,
                           peak_gib=torch.cuda.max_memory_allocated()
                           / 2 ** 30)
        del net, optimizer, state, grads
        torch.cuda.empty_cache()
    un, tpr = sides["unwrapped"], sides["tp"]
    whole = _grad_rel(tpr["grads"], un["grads"])
    loss_rel = abs(tpr["loss"] - un["loss"]) / abs(un["loss"])
    log(f"model_parallel (a): {model} step (batch {BATCH}, {img}x{img}, "
        f"bf16, kernels on), {tpr['sharded']} layers column-parallel in a "
        f"one-rank NCCL group vs unwrapped: loss {tpr['loss']:.6f} vs "
        f"{un['loss']:.6f} (rel {loss_rel:.3e}, tol "
        f"{MODEL_TOL['bfloat16']}); gradients whole normwise rel "
        f"{whole:.3e} (tol {GRAD_TOL['bfloat16']}); step {tpr['ms']:.2f} ms "
        f"vs {un['ms']:.2f} ms; peak {tpr['peak_gib']:.3f} GiB vs "
        f"{un['peak_gib']:.3f} GiB; {card_line()}")
    if not (loss_rel <= MODEL_TOL["bfloat16"]
            and whole <= GRAD_TOL["bfloat16"]):
        raise AssertionError(f"model_parallel (a): {model} TP step "
                             f"{loss_rel} {whole}")
    expect = expected_grad_launches(cfg, 1, streaming)
    for kernel in expect:
        if tpr["launches"][kernel] != un["launches"][kernel]:
            raise AssertionError(
                f"model_parallel (a): {model} {kernel} launched "
                f"{tpr['launches'][kernel]} times under TP, "
                f"{un['launches'][kernel]} unwrapped")
    check_launches(f"model_parallel (a): {model} TP forward and backward",
                   tpr["launches"], expect)
    return dict(loss=tpr["loss"], plain_loss=un["loss"], loss_rel=loss_rel,
                grad_whole_rel=whole, step_ms=tpr["ms"],
                plain_step_ms=un["ms"], peak_gib=tpr["peak_gib"],
                plain_peak_gib=un["peak_gib"],
                layers_sharded=tpr["sharded"]), tpr["launches"]


def model_parallel_cards(torch, tmp, cards, report):
    """Phase 13 (c): the base trainer with "tp": 2 and "sp": 2 (and with
    four cards tp2 x sp2 and dp2 x tp2) against one card, loss by loss;
    `mp_cards_worker` on two cards (tp=2 and sp=2 gradients against one
    card's; the SR and the fused trainers at tp=2 against one card's runs
    here); with four cards "fsdp" composed with each layout
    (`model_parallel_fsdp`); the SR generator with --sp 2 on one image
    against one card, its sampled residual held."""
    import numpy as np
    from sdm_tpu_torch.cli.generate_sr_images_diffusion import \
        generate_sr_images_diffusion
    from sdm_tpu_torch.ops.resize import area_resize
    from sdm_tpu_torch.parallel import multihost as mh
    from sdm_tpu_torch.train import loop
    out = dict(skipped=False, devices=cards)
    data = write_dataset(tmp, IMG)
    layouts = [("one", {}, 1), ("tp2", {"tp": 2}, 2), ("sp2", {"sp": 2}, 2)]
    if cards >= 4:
        layouts += [("tp2_sp2", {"tp": 2, "sp": 2}, 4),
                    ("dp2_tp2", {"tp": 2}, 4)]
    losses = {}
    for name, extra, n in layouts:
        out_dir = os.path.join(tmp, "mp_" + name)
        cfg = dict(train_config(out_dir, data["path"], FLAGSHIP, IMG),
                   max_epoch=10, **extra)
        t0 = time.monotonic()
        with decoders(data["cv2"]):
            loop.run_training(loop.BASE_SPEC, cfg, device="cuda",
                              num_devices=n, max_steps=TRAIN_STEPS)
        wall = time.monotonic() - t0
        with open(os.path.join(out_dir, "Diffusion.log")) as f:
            losses[name] = step_losses(f.read().splitlines())
        rel = (max(abs(a - b) / abs(b) for a, b in
                   zip(losses[name], losses["one"]))
               if name != "one" else 0.0)
        log(f"model_parallel (c): base trainer {name} on {n} card(s), "
            f"{TRAIN_STEPS} steps in {wall:.2f} s: losses {losses[name]} "
            f"(worst rel to one card {rel:.3e}, tol {MODEL_TOL['bfloat16']})")
        if len(losses[name]) != TRAIN_STEPS or \
                not rel <= MODEL_TOL["bfloat16"]:
            raise AssertionError(f"model_parallel (c): {name} losses {rel}")
        out[name] = dict(losses=losses[name], worst_rel=rel, seconds=wall)

    # One-card references of the trainer runs the two- and four-card
    # workers make: the SR trainer, the fused base trainer.
    os.makedirs(os.path.join(tmp, "sr_data"))
    sr_data = write_dataset(os.path.join(tmp, "sr_data"), SR_IMG)
    one = {}
    for name, spec, cfg, img, data_path, extra in (
            ("sr", loop.SR_SPEC, SR, SR_IMG, sr_data["path"], {}),
            ("fused", loop.BASE_SPEC, FLAGSHIP, IMG, data["path"],
             dict(device_dataset=True, steps_per_call=TRAIN_STEPS))):
        out_dir = os.path.join(tmp, f"mp_{name}_one")
        with decoders(data["cv2"]):
            loop.run_training(spec, dict(train_config(out_dir, data_path,
                                                      cfg, img),
                                         max_epoch=10, **extra),
                              device="cuda", num_devices=1,
                              max_steps=TRAIN_STEPS)
        one[name] = trainer_losses(out_dir)
    worker = mh.spawn(mp_cards_worker, 2, "cuda", tmp, data["path"],
                      sr_data["path"], data["cv2"] is not None)
    for name, what, ref in (("sr_tp2", "SR trainer (256x256) at tp=2",
                             "sr"),
                            ("fused_tp2", 'base trainer "device_dataset" '
                             "at tp=2", "fused")):
        got = trainer_losses(os.path.join(tmp, f"mp_{name}"))
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, one[ref]))
        log(f"model_parallel (c): {what} on two cards, {TRAIN_STEPS} steps "
            f"in {worker[name]['seconds']:.2f} s: losses {got} vs one card "
            f"{one[ref]} (worst rel {rel:.3e}, tol {MODEL_TOL['bfloat16']})"
            + (f"; streaming launches per rank {worker[name]['streaming']}"
               if "streaming" in worker[name] else "")
            + f"; rank 0's launches {worker[name]['launches']}")
        if len(got) != TRAIN_STEPS or not rel <= MODEL_TOL["bfloat16"]:
            raise AssertionError(f"model_parallel (c): {name} losses {rel}")
        out[name] = dict(losses=got, one_card=one[ref], worst_rel=rel,
                         **worker[name])
    for name, what in (("sp2_grads", "SR step (kernels off) at sp=2"),
                       ("tp2", "flagship step (kernels on) at tp=2")):
        w = worker[name]
        log(f"model_parallel (c): {what} on two cards vs one card, the "
            f"same seeded batch {BATCH}, bf16: gradients whole normwise rel "
            f"{w['grad_whole_rel']:.3e} (tol {GRAD_TOL['bfloat16']}); loss "
            f"{w['loss']:.6f} vs {w['one_card_loss']:.6f} (rel "
            f"{w['loss_rel']:.3e}); the U-Net's output on a seeded probe, "
            f"worst row normwise rel {w['output_row_rel']:.3e} (tol "
            f"{MODEL_TOL['bfloat16']})")
    one_peak = report["sp_one_rank"]["plain_peak_gib"]
    log(f"model_parallel (c): SR step (batch {BATCH}, bf16) at sp=2 on two "
        f"cards: peak {worker['sp_peak_gib']:.3f} GiB per card vs "
        f"{one_peak:.3f} GiB on one; step {worker['sp_ms']:.2f} ms")
    for name in ("dp2", "tp2"):
        w = worker[name]
        log(f"model_parallel (c): flagship step (batch {BATCH}, bf16) "
            f"{name} on two cards: {w['ms']:.2f} ms; collective bytes per "
            f"card {w['bytes']} (parameters {w['param_bytes']} bytes fp32)")
    out["worker"] = worker
    if cards >= 4:
        out["fsdp"] = model_parallel_fsdp(torch, tmp, data, losses)

    lr = np.random.default_rng(5).integers(0, 256, (SR_IMG // 2,
                                                    SR_IMG // 2, 3),
                                           dtype=np.uint8)
    config = _export(torch, tmp, "sr_mp", SR, SR_IMG, "SR",
                     cond_t=SR_COND_T)
    args = ["-c", config, "--cold_step_size", str(DDIM_STEP), "--dtype",
            "bfloat16", "-s", "3"]
    images, wall = {}, {}
    for name, extra in (("one", ["--num-devices", "1"]), ("sp2", ["--sp",
                                                                  "2"])):
        t0 = time.monotonic()
        images[name] = generate_sr_images_diffusion(
            args + extra, lr_img=lr, log=lambda *a, **k: None,
            save_locally=False)
        wall[name] = time.monotonic() - t0
    # The sampled residual (image minus the upsampled LR input, which both
    # runs share), and the whole image.
    up = area_resize(torch.from_numpy(
        (lr.astype(np.float32) - 127.5) / 127.5)[None], SR_IMG,
        SR_IMG).numpy()
    delta = {k: v - up for k, v in images.items()}
    rel = float(np.linalg.norm(delta["sp2"] - delta["one"])
                / np.linalg.norm(delta["one"]))
    image_rel = float(np.linalg.norm(images["sp2"] - images["one"])
                      / np.linalg.norm(images["one"]))
    share = float(np.linalg.norm(delta["one"])
                  / np.linalg.norm(images["one"]))
    log(f"model_parallel (c): SR generator --sp 2 on one {SR_IMG}x{SR_IMG} "
        f"image vs one card (kernels on there): residual (image minus "
        f"upsampled) normwise rel {rel:.3e} (tol {MODEL_TOL['bfloat16']}; "
        f"the residual's norm is {share:.3f} of the image's); image rel "
        f"{image_rel:.3e}; {wall['sp2']:.2f} s vs {wall['one']:.2f} s")
    if not (images["sp2"].shape == images["one"].shape
            and np.isfinite(images["sp2"]).all()
            and rel <= MODEL_TOL["bfloat16"]):
        raise AssertionError(f"model_parallel (c): SR --sp 2 residual {rel}")
    out["sr_generator"] = dict(residual_rel=rel, image_rel=image_rel,
                               residual_share=share,
                               seconds=wall["sp2"],
                               one_card_seconds=wall["one"])
    return out


def trainer_losses(out_dir):
    """The step losses of a trainer's log (rank 0 writes it)."""
    (name,) = [f for f in os.listdir(out_dir) if f.endswith(".log")]
    with open(os.path.join(out_dir, name)) as f:
        return step_losses(f.read().splitlines())


# Phase 13 (c) on four cards: "fsdp" composed with each model-parallel
# layout, then a resume of the last from its gathered checkpoint.
FSDP_LAYOUTS = (("fsdp_dp2_tp2", {"tp": 2}), ("fsdp_dp2_sp2", {"sp": 2}),
                ("fsdp_tp2_sp2", {"tp": 2, "sp": 2}))
RESUME_STEPS = 2


def model_parallel_fsdp(torch, tmp, data, losses):
    """The base trainer with "fsdp" at dp2 x tp2, dp2 x sp2 and tp2 x sp2
    on four cards (one group, `mp_fsdp_worker`), each step's loss against
    the one-card run's (`losses["one"]`); then the tp2 x sp2 + fsdp run's
    gathered checkpoint resumed on the same layout for RESUME_STEPS steps,
    against the one-card run's checkpoint resumed on one card."""
    from sdm_tpu_torch.parallel import multihost as mh
    from sdm_tpu_torch.train import loop
    out = {}
    worker = mh.spawn(mp_fsdp_worker, 4, "cuda", tmp, data["path"],
                      data["cv2"] is not None)
    seconds = worker["seconds"]
    for name, extra in FSDP_LAYOUTS:
        got = trainer_losses(os.path.join(tmp, f"mp_{name}"))
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, losses["one"]))
        log(f"model_parallel (c): base trainer {name} on 4 cards, "
            f"{TRAIN_STEPS} steps in {seconds[name]:.2f} s: losses {got} "
            f"(worst rel to one card {rel:.3e}, tol "
            f"{MODEL_TOL['bfloat16']}); rank 0's launches "
            f"{worker['launches'][name]}")
        if len(got) != TRAIN_STEPS or not rel <= MODEL_TOL["bfloat16"]:
            raise AssertionError(f"model_parallel (c): {name} losses {rel}")
        out[name] = dict(losses=got, worst_rel=rel, seconds=seconds[name],
                         launches=worker["launches"][name])
    one_dir = os.path.join(tmp, "mp_resume_one")
    with decoders(data["cv2"]):
        loop.run_training(loop.BASE_SPEC, resume_config(
            one_dir, data["path"], os.path.join(tmp, "mp_one")),
            device="cuda", num_devices=1,
            max_steps=TRAIN_STEPS + RESUME_STEPS)
    got = trainer_losses(os.path.join(tmp, "mp_fsdp_resume"))
    want = trainer_losses(one_dir)
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    log(f"model_parallel (c): tp2 x sp2 + fsdp resumed from its gathered "
        f"step-{TRAIN_STEPS} checkpoint on 4 cards, {RESUME_STEPS} steps in "
        f"{seconds['fsdp_resume']:.2f} s: losses {got} vs the one-card "
        f"resume {want} (worst rel {rel:.3e}, tol {MODEL_TOL['bfloat16']})")
    if len(got) != RESUME_STEPS or not rel <= MODEL_TOL["bfloat16"]:
        raise AssertionError(f"model_parallel (c): fsdp resume {rel}")
    out["resume"] = dict(losses=got, one_card=want, worst_rel=rel,
                         seconds=seconds["fsdp_resume"])
    return out


def resume_config(out_dir, data_path, src_dir):
    """The flagship base config resuming (Adam included) from `src_dir`'s
    step-TRAIN_STEPS checkpoint."""
    ckpt = os.path.join(src_dir, "checkpoint")
    return dict(train_config(out_dir, data_path, FLAGSHIP, IMG),
                max_epoch=10, load_diffusion_optim=True,
                model_checkpoint=os.path.join(
                    ckpt, f"diffusion_{TRAIN_STEPS}.pt"),
                config_checkpoint=os.path.join(
                    ckpt, f"config_{TRAIN_STEPS}.pt"))


def mp_fsdp_worker(tmp, data_path, has_cv2):
    """A rank of phase 13 (c)'s four-card group: the base trainer with
    "fsdp" in each FSDP_LAYOUTS layout, then the tp2 x sp2 + fsdp run
    resumed from its checkpoint, every run in this one group. Returns
    each run's seconds and this rank's launches."""
    import torch
    from sdm_tpu_torch.train import loop
    cv2 = __import__("cv2") if has_cv2 else None
    counters = kernel_counters()
    seconds, launches = {}, {}
    runs = [(name, dict(train_config(os.path.join(tmp, f"mp_{name}"),
                                     data_path, FLAGSHIP, IMG),
                        max_epoch=10, fsdp=True, **extra), TRAIN_STEPS)
            for name, extra in FSDP_LAYOUTS]
    runs.append(("fsdp_resume", dict(resume_config(
        os.path.join(tmp, "mp_fsdp_resume"), data_path,
        os.path.join(tmp, "mp_fsdp_tp2_sp2")), fsdp=True, tp=2, sp=2),
        TRAIN_STEPS + RESUME_STEPS))
    for name, cfg, steps in runs:
        t0 = time.monotonic()
        zero_counts(counters)
        with decoders(cv2):
            loop.run_training(loop.BASE_SPEC, cfg, device="cuda",
                              max_steps=steps)
        torch.cuda.synchronize()
        seconds[name] = time.monotonic() - t0
        launches[name] = read_counts(counters)
    return dict(seconds=seconds, launches=launches)


def mp_cards_worker(tmp, data_path, sr_data_path, has_cv2):
    """A rank of phase 13 (c)'s two-card group. One SR step's gradients at
    sp=2 (kernels off) and one flagship step's at tp=2 (tp_min_width 256,
    kernels on), each on the whole seeded batch, held at GRAD_TOL to the
    same step on this card alone (the unwrapped U-Net, the same seed and
    kernels), and the U-Net's output on a seeded probe held row by row at
    MODEL_TOL; the sp=2 step's peak memory and time; then one flagship step
    under DP and under TP, each's collective bytes on this card
    (parallel/analysis.py) and time; then, in this group, the SR trainer
    and the fused base trainer ("device_dataset") at tp=2 for TRAIN_STEPS
    steps each, writing their logs for the parent to hold to one card's,
    and each rank's streaming launches in the SR run (rank 0 also runs the
    preview). Rank 0's result is returned; a rank whose gradients or
    streaming launches disagree raises."""
    import torch
    from sdm_tpu_torch.enums import Objective
    from sdm_tpu_torch.models import UNet
    from sdm_tpu_torch.ops.schedules import make_schedule
    from sdm_tpu_torch.parallel import _comm, analysis, sp, tp
    from sdm_tpu_torch.parallel.mesh import make_model_mesh, shard_rows
    from sdm_tpu_torch.train.step import (create_train_state, make_optimizer,
                                          make_train_step)
    dev = torch.device("cuda", torch.cuda.current_device())
    schedule = make_schedule("LINEAR", beta_1=5e-3, beta_T=9e-3,
                             max_noise_step=1000, device=dev)
    out = {}

    def unet(cfg, kernels):
        torch.manual_seed(0)
        return UNet(**cfg, dtype=torch.bfloat16, use_kernels=kernels).to(
            dev, memory_format=torch.channels_last)

    def setup(cfg, mesh, kernels):
        net = unet(cfg, kernels)
        sharded = (tp.shard_model(net, mesh.model_group)
                   if mesh.tp > 1 else {})
        optimizer, lr_schedule = make_optimizer(net.parameters(), 2e-5,
                                                100_000)
        state = create_train_state(net, optimizer, lr_schedule)
        state.model = _comm.data_parallel(net, dev, mesh.reduce_group,
                                          count_bytes=True)
        params = sum(p.numel() * p.element_size() for p in net.parameters())
        return state, params, sharded

    def probe(cfg, seed):
        """A seeded U-Net input and t for the forward check."""
        gen = torch.Generator().manual_seed(seed)
        hw = SR_IMG if cfg is SR else IMG
        return (torch.randn((BATCH, hw, hw, cfg["in_channel"]),
                            generator=gen).to(dev, torch.bfloat16),
                torch.randint(1, 1000, (BATCH,), generator=gen).to(dev))

    def one_card(cfg, kernels, step, batch, x):
        """The step's loss and gradients, and the U-Net's output on the
        probe `x`, on this card alone."""
        net = unet(cfg, kernels)
        loss = step.loss_fn(net, batch, None)
        loss.backward()
        with torch.no_grad():
            y = net(*x, None)
        got = (loss.item(), _grads(net), y)
        del net
        torch.cuda.empty_cache()
        return got

    def held(name, state, sharded, mesh, step, batch, want, x, space=None):
        """The parallel step's global loss and whole gradients (the
        shards gathered over the model group), and the output on the probe
        `x` (the slabs gathered over the space group), against `want`.
        The output is held row by row: a wrong halo or gather shows in the
        rows at a slab's edge, which the whole gradients dilute."""
        net = state.model.module
        net.zero_grad(set_to_none=True)
        with torch.no_grad(), sp.spatial(space):
            y = net(x[0] if space is None else sp.slab(x[0], space), x[1],
                    None)
        if space is not None:
            y = _comm.all_gather(y.contiguous(), mesh.space_group, 1)
        diff = (y.float() - want[2].float()).square().sum(dim=(0, 2, 3))
        row_rel = float((diff / want[2].float().square().sum(
            dim=(0, 2, 3))).sqrt().max())
        with sp.spatial(space):
            loss = step.loss_fn(state.model, batch, None)
            loss.backward()
        world = torch.distributed.get_world_size()
        loss = float(_comm.all_reduce(loss.detach().float().reshape(1),
                                      None)) / world
        grads = {n: (_comm.all_gather(g, mesh.model_group, sharded[n])
                     if n in sharded else g)
                 for n, g in _grads(net).items()}
        net.zero_grad(set_to_none=True)
        rel = _grad_rel(grads, want[1])
        loss_rel = abs(loss - want[0]) / abs(want[0])
        if not (rel <= GRAD_TOL["bfloat16"]
                and loss_rel <= MODEL_TOL["bfloat16"]
                and row_rel <= MODEL_TOL["bfloat16"]):
            raise AssertionError(f"model_parallel (c): {name} gradients "
                                 f"{rel}, loss {loss_rel}, output rows "
                                 f"{row_rel}")
        return dict(loss=loss, one_card_loss=want[0], loss_rel=loss_rel,
                    grad_whole_rel=rel, output_row_rel=row_rel)

    mesh = make_model_mesh("cuda", 1, 2)
    batch = _seeded_batch(torch, SR_IMG, 23, dev)
    space = sp.SpaceShard(mesh.space_group, mesh.space, 2)
    step = make_train_step(schedule, objective=Objective.RESIDUAL_X0,
                           cond_t=SR_COND_T, lr_dim=SR_IMG // 2, space=space)
    plain = make_train_step(schedule, objective=Objective.RESIDUAL_X0,
                            cond_t=SR_COND_T, lr_dim=SR_IMG // 2)
    x = probe(SR, 25)
    want = one_card(SR, False, plain, batch, x)
    state, _, _ = setup(SR, mesh, False)
    out["sp2_grads"] = held("sp2", state, {}, mesh, step, batch, want, x,
                            space)
    del want, x
    step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out["sp_ms"] = time_ms(lambda: step(state, batch), 2)
    out["sp_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del state, batch
    torch.cuda.empty_cache()

    batch = _seeded_batch(torch, IMG, 24, dev)
    for name, tp_n in (("dp2", 1), ("tp2", 2)):
        mesh = make_model_mesh("cuda", tp_n, 1)
        rows = shard_rows(BATCH, mesh.data, mesh.dp)
        local = {k: v[rows] for k, v in batch.items()}
        step = make_train_step(schedule, objective=Objective.EPS,
                               shard=(mesh.data, mesh.dp))
        if name == "tp2":
            x = probe(FLAGSHIP, 26)
            want = one_card(FLAGSHIP, True, step, batch, x)
        state, param_bytes, sharded = setup(FLAGSHIP, mesh, True)
        out[name] = {}
        if name == "tp2":
            out[name] = held(name, state, sharded, mesh, step, local, want,
                             x)
            del want, x
        step(state, local)
        nbytes = analysis.step_collective_bytes(step, state, local)
        torch.cuda.synchronize()
        out[name].update(bytes=nbytes, layers_sharded=len(sharded),
                         param_bytes=param_bytes,
                         ms=time_ms(lambda: step(state, local), 3))
        del state
        torch.cuda.empty_cache()

    from sdm_tpu_torch.train import loop
    counters = kernel_counters()
    rank = torch.distributed.get_rank()
    for name, spec, cfg, img, path, extra in (
            ("sr_tp2", loop.SR_SPEC, SR, SR_IMG, sr_data_path, {}),
            ("fused_tp2", loop.BASE_SPEC, FLAGSHIP, IMG, data_path,
             dict(device_dataset=True, steps_per_call=TRAIN_STEPS))):
        config = dict(train_config(os.path.join(tmp, f"mp_{name}"), path,
                                   cfg, img), max_epoch=10, tp=2, **extra)
        t0 = time.monotonic()
        zero_counts(counters)
        with decoders(__import__("cv2") if has_cv2 else None):
            loop.run_training(spec, config, device="cuda",
                              max_steps=TRAIN_STEPS)
        torch.cuda.synchronize()
        out[name] = dict(seconds=time.monotonic() - t0,
                         launches=read_counts(counters))
        if name == "sr_tp2":
            got = read_counts(counters)
            expect = (expected_train_launches if rank == 0
                      else expected_grad_launches)(SR, TRAIN_STEPS, 1)
            check_launches(f"model_parallel (c): SR trainer at tp=2, rank "
                           f"{rank}", got, expect)
            per_rank = [None] * torch.distributed.get_world_size()
            torch.distributed.all_gather_object(
                per_rank, {k: got[k] for k in got
                           if k.startswith("streaming_")})
            out[name]["streaming"] = per_rank
        torch.cuda.empty_cache()
    return out


TOOL_STEPS = 2


def tooling_phase(torch, counters):
    """Phase 14: (a) the base trainer on the flagship with
    "profile_trace_dir" for TOOL_STEPS steps (launches held): the trace
    file exists, parses, and names the port's kernels; (b) a run with
    "native_checkpoint" (and an EMA), then its state resumed for two more
    steps from the native directory and from the .pt + config pair: the
    two resumed states (parameters, EMA, Adam) bit for bit equal; (c) the
    loader's decode path: with cv2 and the native decoder, its batches
    against the per-image path's, bit for bit; else one line says what is
    missing. Returns (a)'s launches and a report."""
    import glob
    import numpy as np
    from sdm_tpu_torch.data import DataLoader, ImageDataset, native
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = write_dataset(tmp, IMG)
        # (a) The profiler trace.
        trace_dir = os.path.join(tmp, "trace")
        t0 = time.monotonic()
        summary, launches, _ = run_trainer(
            torch, counters, os.path.join(tmp, "traced"), data,
            {"profile_trace_dir": trace_dir}, TOOL_STEPS)
        wall = time.monotonic() - t0
        check_launches("tooling (a): traced base run", launches,
                       expected_train_launches(FLAGSHIP, TOOL_STEPS, 0))
        files = os.listdir(trace_dir)
        path = os.path.join(trace_dir, "trace_rank0.json")
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        kernels = {e.get("name", "") for e in events
                   if e.get("cat") == "kernel"}
        found = {want: sum(want in k for k in kernels)
                 for want in ("adagn_", "attn_stats_wgmma",
                              "attn_apply_wgmma", "linear_wgmma")}
        log(f"tooling (a): base run with profile_trace_dir, {TOOL_STEPS} "
            f"steps and the step-0 preview in {wall:.2f} s: trace files "
            f"{files}, {os.path.getsize(path)} bytes, {len(events)} events, "
            f"{len(kernels)} distinct kernels; the port's kernels by name: "
            f"{found}")
        if files != ["trace_rank0.json"] or not all(found.values()):
            raise AssertionError(f"tooling (a): trace {files} {found}")
        report["trace"] = dict(seconds=wall, bytes=os.path.getsize(path),
                               events=len(events), port_kernels=found)
        del events, kernels

        # (b) A native checkpoint, resumed against the .pt + config resume.
        first = os.path.join(tmp, "native")
        run_trainer(torch, counters, first, data,
                    dict(native_checkpoint=True, ema_decay=0.999),
                    TOOL_STEPS)
        ckpt = os.path.join(first, "checkpoint")
        states, losses = {}, {}
        for name, extra in (
                ("pt", dict(model_checkpoint=os.path.join(
                    ckpt, f"diffusion_{TOOL_STEPS}.pt"),
                    config_checkpoint=os.path.join(
                        ckpt, f"config_{TOOL_STEPS}.pt"),
                    load_diffusion_optim=True)),
                ("native", dict(model_checkpoint=os.path.join(
                    ckpt, f"native_{TOOL_STEPS}")))):
            got, _, lines = run_trainer(
                torch, counters, os.path.join(tmp, f"resume_{name}"), data,
                dict(ema_decay=0.999, **extra), TOOL_STEPS + 2)
            st = got["state"]
            states[name] = dict(
                model=st.model.state_dict(), ema=st.ema,
                adam=[v for s_ in st.optimizer.state_dict()["state"].values()
                      for v in s_.values()])
            losses[name] = step_losses(lines)
        worst = max(float((a.float() - b.float()).abs().max())
                    for key in ("model", "ema", "adam")
                    for a, b in zip(
                        (states["pt"][key].values() if key != "adam"
                         else states["pt"][key]),
                        (states["native"][key].values() if key != "adam"
                         else states["native"][key])))
        native_files = sorted(os.listdir(os.path.join(
            ckpt, f"native_{TOOL_STEPS}")))
        log(f"tooling (b): native checkpoint {native_files} resumed for 2 "
            f"steps vs the .pt + config resume: losses {losses['native']} "
            f"vs {losses['pt']}; parameters, EMA and Adam state max abs "
            f"difference {worst:.3e} (must be 0)")
        if worst != 0.0 or losses["native"] != losses["pt"]:
            raise AssertionError(f"tooling (b): native resume {worst}")
        report["native"] = dict(files=native_files, losses=losses,
                                max_abs_diff=worst)
        del states

        # (c) The loader's decode path.
        if data["cv2"] is None:
            log("tooling (c): no cv2 on this machine: the datasets read "
                ".npy files per image; the native decoder was not checked")
            report["decode"] = dict(path="per-image (.npy, no cv2)")
        elif not native.available():
            import shutil
            include = ("/usr/include", "/usr/local/include",
                       "/usr/include/x86_64-linux-gnu")
            missing = ([] if shutil.which("g++") else ["g++"]) + [
                h for h in ("jpeglib.h", "png.h")
                if not any(os.path.exists(os.path.join(d, h))
                           for d in include)]
            log(f"tooling (c): the native decoder is off on this machine "
                f"({'missing: ' + ', '.join(missing) if missing else 'its build or canary failed'}): "
                "the loader decodes per image with cv2")
            report["decode"] = dict(path="per-image (no native decoder)",
                                    missing=missing)
        else:
            dataset = ImageDataset(sorted(glob.glob(data["path"])),
                                   normalized=False)
            batches, seconds = {}, {}
            for nat in (True, False):
                t0 = time.monotonic()
                loader = DataLoader(dataset, batch_size=BATCH, shuffle=True,
                                    seed=0, native_decode=nat)
                batches[nat] = [b["image"] for b in loader]
                seconds[nat] = time.monotonic() - t0
                if loader._native != nat:
                    raise AssertionError("tooling (c): the native decoder "
                                         "turned itself off")
            same = all(np.array_equal(a, b) for a, b in
                       zip(batches[True], batches[False]))
            log(f"tooling (c): the loader decodes natively "
                f"(sdm_tpu_torch/csrc/sdm_decode.cc): {len(batches[True])} "
                f"batches of {BATCH} PNGs bit-identical to the per-image "
                f"cv2 path: {same}; {seconds[True]:.3f} s vs "
                f"{seconds[False]:.3f} s (host clock, one pass)")
            if not same or len(batches[True]) != len(batches[False]):
                raise AssertionError("tooling (c): native batches differ")
            report["decode"] = dict(path="native", seconds=seconds[True],
                                    per_image_seconds=seconds[False])
    return launches, report


def summarize(results, launches):
    """One entry per kernel: the main path's shapes (bf16, query axis),
    times summed over one U-Net call: the flagship's for the kernels of
    slice 1, the SR model's for the streaming kernels (forward: one SR
    U-Net call; backward: one SR train step). `launches` sums the served,
    generated and trained paths' launches of each kernel, whichever wrapper
    made them (the whole-S attention's and `linear`'s kernels also run
    inside the block's one C call), `wrapper_launches` the wrapper's own
    calls; `launches_by_path` keeps the wrapper counts apart, and
    `mma_launches` counts those that ran the tensor-core kernels (all of
    them TMA + wgmma; the streaming passes' `wgmma_launches` say so too),
    and AdaGN's
    `one_pass_launches` / `two_pass_launches` its two routes. No library
    call normalizes over queries, so the query-axis `library_ms` is null;
    the key-axis kernel time sits beside SDPA's (`k_axis_ms`,
    `k_axis_library_ms`: the whole-S attention per flagship call, the
    streaming forward, stats + apply, per SR call). `linear` sums both
    projections of every block per flagship call, its library time
    F.linear's (cuBLAS), and it and AdaGN (library: F.group_norm + FiLM)
    add both queued behind a sleep kernel (`queued_ms`,
    `library_queued_ms`: device time without the host's) and the same per
    SR call (`sr_*`). The whole-S attention
    adds its queued times on both axes (`queued_ms`, `k_axis_queued_ms`,
    SDPA's `k_axis_library_queued_ms`) and the same per SR call, its three
    whole-S blocks (`sr_*`, `sr_k_axis_*`). The block adds its queued time
    per flagship call, the same per SR call (its four blocks, the
    streaming one composed) and each shape's route and times
    (`by_shape`)."""
    meta = {
        "fused_adagn": ("adagn", "flagship",
                        "sdm_tpu_torch/csrc/adagn.cu (adagn_grid; + "
                        "async_tiles.cuh)",
                        "sdm_tpu/kernels/adagn.py:115", ADAGN_PER_CALL),
        "fused_attention": ("attention", "flagship",
                            "sdm_tpu_torch/csrc/attention.cu + "
                            "attention_kernels.cuh (+ wgmma_tiles.cuh)",
                            "sdm_tpu/kernels/attention.py:86", 1),
        "fused_attention_block": ("attention_block", "flagship",
                                  "sdm_tpu_torch/csrc/attention_block.cu "
                                  "(+ attention_kernels.cuh, "
                                  "linear_kernels.cuh, wgmma_tiles.cuh)",
                                  "sdm_tpu/kernels/attention_block.py:88",
                                  1),
        "linear": ("linear", "flagship", "sdm_tpu_torch/csrc/linear.cu + "
                   "linear_kernels.cuh (+ wgmma_tiles.cuh)",
                   "sdm_tpu/kernels/attention_block.py:66", 1),
        "streaming_stats": ("streaming_stats", "sr",
                            "sdm_tpu_torch/csrc/streaming_attention.cu "
                            "(stream_stats_wgmma; + wgmma_tiles.cuh)",
                            "sdm_tpu/kernels/streaming_attention.py:223", 1),
        "streaming_apply": ("streaming_apply", "sr",
                            "sdm_tpu_torch/csrc/streaming_attention.cu "
                            "(stream_apply_wgmma; + wgmma_tiles.cuh)",
                            "sdm_tpu/kernels/streaming_attention.py:234", 1),
        "streaming_dv": ("streaming_dv", "sr",
                         "sdm_tpu_torch/csrc/streaming_attention.cu "
                         "(stream_apply_wgmma<..., dv_pass>; + "
                         "wgmma_tiles.cuh)",
                         "sdm_tpu/kernels/streaming_attention.py:298", 1),
        "streaming_dk": ("streaming_dk", "sr",
                         "sdm_tpu_torch/csrc/streaming_attention.cu "
                         "(stream_da_wgmma; + wgmma_tiles.cuh)",
                         "sdm_tpu/kernels/streaming_attention.py:260", 1),
        "streaming_dq": ("streaming_dq", "sr",
                         "sdm_tpu_torch/csrc/streaming_attention.cu "
                         "(stream_da_wgmma; + wgmma_tiles.cuh)",
                         "sdm_tpu/kernels/streaming_attention.py:271", 1),
    }
    # STREAM_SHAPES[0] is the SR model's one streaming block.
    shapes = {"flagship": None, "sr": [[BATCH, *STREAM_SHAPES[0]]]}
    def main_rows(kernel, model, axis):
        return [r for r in results if r["kernel"] == kernel
                and r["model"] == model and r["dtype"] == "bfloat16"
                and r.get("axis", "q") == axis
                and (shapes[model] is None or r["shape"] in shapes[model])]

    def k_axis(kernel, model, per_call):
        rows = main_rows(kernel, model, "k")
        return dict(k_axis_ms=sum(r["ms"] for r in rows) * per_call,
                    k_axis_library_ms=sum(r["library_ms"] for r in rows)
                    * per_call)

    queued = ("queued_ms", "library_queued_ms")

    def attention_calls():
        """The whole-S attention per flagship call (its four shapes) and
        per SR call (the SR model's three whole-S shapes), both axes."""
        out = {}
        for axis, tag in (("q", ""), ("k", "k_axis_")):
            for model, pre in (("flagship", ""), ("sr", "sr_")):
                rows = [r for r in results if r["kernel"] == "attention"
                        and r["dtype"] == "bfloat16" and r["axis"] == axis
                        and (r["model"] == "flagship" if model == "flagship"
                             else (r["shape"][1], r["shape"][3])
                             in SR_BLOCK_SHAPES)]
                keys = ["ms", "queued_ms", "bound_ms", "plain_ms"]
                if axis == "k":
                    keys += ["library_ms", "library_queued_ms"]
                for key in keys:
                    if (pre, tag) == ("", "") and key in ("ms", "bound_ms",
                                                          "plain_ms"):
                        continue   # the entry's own keys
                    out[f"{pre}{tag}{key}"] = sum(r[key] for r in rows)
        return out

    def sr_call(kernel, in_sr, per_call, keys=()):
        """Times and bounds per SR call: the rows of the SR model's shapes,
        whichever model's checks measured them."""
        rows = [r for r in results if r["kernel"] == kernel
                and r["dtype"] == "bfloat16" and in_sr(r["shape"])]
        return {f"sr_{key}": sum(r[key] for r in rows) * per_call
                for key in ("ms", "library_ms", "bound_ms", "plain_ms",
                            *keys)}

    extra = {
        "fused_attention": attention_calls(),
        "streaming_stats": k_axis("streaming_attention", "sr", 1),
        "streaming_apply": k_axis("streaming_attention", "sr", 1),
        "fused_adagn": {**sr_call("adagn", lambda sh: tuple(sh[1:])
                                  in SR_ADAGN_SHAPES, ADAGN_PER_CALL,
                                  queued),
                        **{key: sum(r[key] for r in main_rows(
                            "adagn", "flagship", "q")) * ADAGN_PER_CALL
                           for key in queued}},
        "linear": {**sr_call("linear", lambda sh: (sh[0] // BATCH, sh[2])
                             in SR_BLOCK_SHAPES, 1, queued),
                   **{key: sum(r[key] for r in main_rows("linear",
                                                         "flagship", "q"))
                      for key in queued}}}
    block_rows = [r for r in results if r["kernel"] == "attention_block"
                  and r["dtype"] == "bfloat16" and r["axis"] == "q"]
    extra["fused_attention_block"] = {
        "queued_ms": sum(r["queued_ms"] for r in block_rows
                         if r["model"] == "flagship"),
        **{f"sr_{key}": sum(r[key] for r in block_rows
                            if tuple(r["shape"][1:]) in SR_BLOCK_SHAPES)
           for key in ("ms", "queued_ms", "bound_ms", "plain_ms")},
        "by_shape": [{key: r[key] for key in ("model", "shape", "route", "ms",
                                              "queued_ms", "plain_ms",
                                              "bound_ms")}
                     for r in block_rows]}

    def kernel_launches(name, path):
        """Launches of the kernels behind `name` on a path: the wrapper's
        own, and for the whole-S attention and `linear` also those made by
        the block's one C call (each whole-S block on the tensor cores
        launches the attention's two kernels and `linear_wgmma` twice, once
        where its apply carries the output projection)."""
        n = path[name]
        wgmma = path["fused_attention_block_wgmma"]
        if name == "fused_attention":
            n += wgmma
        elif name == "linear":
            n += 2 * wgmma - path["fused_attention_block_fused_out"]
        return n

    out = []
    for name, (kernel, model, source, replaces, per_call) in meta.items():
        rows = main_rows(kernel, model, "q")
        lib = [r["library_ms"] for r in rows]
        out.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(kernel_launches(name, path)
                         for path in launches.values()),
            wrapper_launches=sum(path[name] for path in launches.values()),
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=sum(r["ms"] for r in rows) * per_call,
            plain_ms=sum(r["plain_ms"] for r in rows) * per_call,
            bound_ms=sum(r["bound_ms"] for r in rows) * per_call,
            bound_by=max(rows, key=lambda r: r["bound_ms"])["bound_by"],
            library_ms=(None if any(v is None for v in lib)
                        else sum(lib) * per_call),
            launches_by_path={path: n[name] for path, n in launches.items()},
            **{f"{kind}_launches": sum(path[f"{name}_{kind}"]
                                       for path in launches.values())
               for _, kind in SUB_COUNTS
               if f"{name}_{kind}" in next(iter(launches.values()))},
            **extra.get(name, {}),
            per=(f"one {model} "
                 + ("train step" if name.startswith("streaming_d")
                    else "U-Net call")
                 + ", batch 16, bf16, query axis")))
    return out


PHASES = ("build", "kernels", "streaming", "model", "serving", "generation",
          "training", "extensions", "remat", "loop", "distill", "eval",
          "parallel", "model_parallel", "tooling")


def parse_phases(argv):
    """The phases to run: all of PHASES by default, else those named by
    `--phases a,b` (the build runs whenever any phase runs)."""
    if not argv:
        return list(PHASES)
    if len(argv) != 2 or argv[0] != "--phases":
        raise SystemExit(f"usage: chip_smoke.py [--phases "
                         f"{','.join(PHASES)}]")
    names = [n for n in argv[1].split(",") if n]
    unknown = [n for n in names if n not in PHASES]
    if unknown or not names:
        raise SystemExit(f"chip_smoke: unknown phases {unknown}; choose "
                         f"from {','.join(PHASES)}")
    return [n for n in PHASES if n == "build" or n in names]


def ptxas_report(text):
    """{kernel: {registers, spill_bytes}} from nvcc's -Xptxas -v output:
    each "Compiling entry function" or "Function properties for" line names
    the kernel that the following spill and register lines describe."""
    out, name = {}, None
    for line in text.splitlines():
        m = (re.search(r"Compiling entry function '([^']+)'", line)
             or re.search(r"Function properties for (\S+)", line))
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def demangle(names):
    try:
        res = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        lines = res.stdout.splitlines()
        if res.returncode == 0 and len(lines) == len(names):
            return lines
    except OSError:
        pass
    return list(names)


# The tensor-core kernels of each library, with the instantiations ptxas
# must report: the whole-S library's TMA + wgmma stats (one) and apply (two
# axes x one to four output chunks a warpgroup), the streaming library's
# TMA + wgmma dA kernel (dK and dQ x two stat layouts x one to four output
# chunks a warpgroup), its TMA + wgmma forward (the stats at 64 and 128
# kept rows a block; the apply at two axes x bf16 and fp32 output x one to
# four output chunks a warpgroup in loads of four chunks, and three or four
# in loads of eight: 24) and dV on the same apply (dv_pass, fp32 output
# alone: 12 more), and the TMA + wgmma GEMM (the 128 x 128 and 128 x 64
# tiles); beside them AdaGN's one-pass kernel (bulk copies, one). The
# block's library holds the whole-S attention's and the GEMM's kernels
# again (their one source, attention_kernels.cuh and linear_kernels.cuh)
# and the two apply instantiations that carry the output projection
# (attn_apply_wgmma<axis, 4, true>).
MMA_KERNELS = {"adagn": {"adagn_grid": 1},
               "attention": {"attn_stats_wgmma": 1, "attn_apply_wgmma": 8},
               "attention_block": {"attn_stats_wgmma": 1,
                                   "attn_apply_wgmma": 10,
                                   "linear_wgmma": 2},
               "streaming_attention": {"stream_da_wgmma": 16,
                                       "stream_stats_wgmma": 2,
                                       "stream_apply_wgmma": 36},
               "linear": {"linear_wgmma": 2}}


def build_phase(torch):
    """Build every library, log each kernel's registers and spills, and
    hold every instantiation of the tensor-core kernels and AdaGN's one-pass
    kernel (MMA_KERNELS) to 0 spill bytes. Returns their ptxas report and
    dynamic shared memory."""
    from sdm_tpu_torch.kernels import _build
    from sdm_tpu_torch.kernels import adagn as ag
    from sdm_tpu_torch.kernels import attention as attn_mod
    from sdm_tpu_torch.kernels import attention_block as ab
    from sdm_tpu_torch.kernels import streaming_attention as sa
    t0 = time.monotonic()
    _build.build()
    log(f"build: {time.monotonic() - t0:.1f} s for {list(_build.SOURCES)}")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    smem = {"adagn_grid": (ag.adagn_plan(BATCH, 64 * 64, ag.MAX_C, GROUPS,
                                         torch.bfloat16,
                                         torch.bfloat16).smem,
                           f"C = {ag.MAX_C}"),
            "stream_da_wgmma": (sa.da_wgmma_smem_bytes(sa.DA_MAX_D),
                                f"D = {sa.DA_MAX_D}"),
            "attn_stats_wgmma": (attn_mod.wgmma_smem_bytes(1024)[0],
                                 "D = 1024"),
            "attn_apply_wgmma": (attn_mod.wgmma_smem_bytes(1024)[1],
                                 "D = 1024"),
            "stream_stats_wgmma": (sa.wgmma_smem_bytes(512)[0], "D = 512"),
            "stream_apply_wgmma": (sa.wgmma_smem_bytes(512)[1], "D = 512"),
            "linear_wgmma": (max(map(ab.linear_wgmma_smem_bytes,
                                     ab.LINEAR_TILES)),
                             "the larger of its tiles "
                             f"{ab.LINEAR_TILES}")}
    out = {}
    for lib, kernels in MMA_KERNELS.items():
        report = ptxas_report(_build.build_log(lib))
        for kernel, count in kernels.items():
            found = {k: v for k, v in report.items()
                     if kernel in k and "registers" in v}
            if len(found) != count:
                raise AssertionError(
                    f"ptxas reports {len(found)} {kernel} instantiations in "
                    f"lib{lib}, expected {count}: {list(found)}")
            nbytes, at = smem[kernel]
            for pretty, info in zip(demangle(list(found)), found.values()):
                info["name"] = pretty
                log(f"  {lib}: {pretty}: {info['registers']} registers, "
                    f"{info.get('spill_bytes')} spill bytes, {nbytes} bytes "
                    f"of dynamic shared memory at {at}")
                if info.get("spill_bytes") != 0:
                    raise AssertionError(f"{pretty} spills "
                                         f"{info.get('spill_bytes')} bytes")
            out.setdefault(kernel, []).extend(found.values())
    # ptxas says where it serializes a kernel's wgmma (the C7510-C7520
    # "wgmma ... serialized" info lines): none for the streaming forward
    # or its dK and dQ, none in the block's library (the whole-S attention,
    # the apply with the output projection, the GEMM).
    for lib in ("streaming_attention", "attention_block"):
        serialized = [line.strip() for line in
                      _build.build_log(lib).splitlines()
                      if "serializ" in line and "wgmma" in line]
        if serialized:
            raise AssertionError(f"ptxas serialized wgmma in lib{lib}: "
                                 f"{serialized}")
    log("  streaming_attention: no serialized wgmma in stream_stats_wgmma, "
        "stream_apply_wgmma (forward and dV) or stream_da_wgmma; "
        "attention_block: none in attn_stats_wgmma, attn_apply_wgmma (with "
        "and without the output projection) or linear_wgmma")
    out["smem_bytes"] = {k: v[0] for k, v in smem.items()}
    return out


def main(argv) -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from sdm_tpu_torch.kernels.adagn import fused_adagn
        from sdm_tpu_torch.kernels.attention import fused_attention
        from sdm_tpu_torch.kernels.attention_block import (
            fused_attention_block, linear)
        from sdm_tpu_torch.kernels.streaming_attention import (
            streaming_apply, streaming_dk, streaming_dq, streaming_dv,
            streaming_stats)
        from sdm_tpu_torch.train.loop import (BASE_SPEC, COLD_SPEC,
                                              DOODLE_SPEC, SR_SPEC)
    except ImportError as e:
        print(f"chip_smoke: the sdm_tpu_torch package is missing ({e}); run "
              "from the repository root", file=sys.stderr)
        return 2
    phases = parse_phases(argv)
    skipped = [n for n in PHASES if n not in phases]

    t_start = time.monotonic()
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    if skipped:
        log(f"phases: running {phases}; skipping {skipped}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    out = dict(card=card, torch=torch.__version__, phases=phases)
    out["build"] = build_phase(torch)
    results = []
    out["results"] = results
    for name, fn in (("kernels", kernel_phase),
                     ("streaming", streaming_phase)):
        if name in phases:
            t0 = time.monotonic()
            fn(torch, results)
            log(f"{name} phase: {time.monotonic() - t0:.1f} s")
    if "model" in phases:
        t0 = time.monotonic()
        out["model"] = {"flagship": model_phase(torch, "flagship", FLAGSHIP,
                                                IMG),
                        "sr": model_phase(torch, "sr", SR, SR_IMG)}
        out["grads"] = {
            "flagship": grad_phase(torch, "flagship", FLAGSHIP, IMG, 0),
            "sr": grad_phase(torch, "sr", SR, SR_IMG, 1)}
        log(f"model phase: {time.monotonic() - t0:.1f} s")
    counters = kernel_counters()
    launches = {}
    if "serving" in phases:
        t0 = time.monotonic()
        served = out["served"] = {}
        launches["flagship"], served["flagship"], lr_images = serving_phase(
            torch, counters)
        launches["sr"], served["sr"] = sr_serving_phase(torch, counters,
                                                        lr_images)
        log(f"serving phase: {time.monotonic() - t0:.1f} s")
    if "generation" in phases:
        t0 = time.monotonic()
        launches["generation"], out["generated"] = generation_phase(
            torch, counters)
        log(f"generation phase: {time.monotonic() - t0:.1f} s")
    if "training" in phases:
        t0 = time.monotonic()
        trained = out["trained"] = {}
        launches["sr_train"], trained["sr"] = train_phase(
            torch, counters, SR_SPEC, "sr", SR, SR_IMG, streaming=1)
        launches["base_train"], trained["base"] = train_phase(
            torch, counters, BASE_SPEC, "base", FLAGSHIP, IMG, streaming=0)
        launches["cold_train"], trained["cold"] = train_phase(
            torch, counters, COLD_SPEC, "cold", COLD, IMG, streaming=0)
        launches["doodle_train"], trained["doodle"] = train_phase(
            torch, counters, DOODLE_SPEC, "doodle", DOODLE, IMG, streaming=0)
        log(f"training phase: {time.monotonic() - t0:.1f} s")
    if "extensions" in phases:
        t0 = time.monotonic()
        ext_launches, out["extensions"] = extensions_phase(torch, counters)
        launches.update(ext_launches)
        log(f"extensions phase: {time.monotonic() - t0:.1f} s")
    for name, path, fn in (("remat", "sr_remat", remat_phase),
                           ("loop", "fused_train", loop_phase),
                           ("distill", "distill", distill_phase),
                           ("eval", "eval", eval_phase),
                           ("parallel", "parallel", parallel_phase),
                           ("model_parallel", "model_parallel",
                            model_parallel_phase),
                           ("tooling", "tooling", tooling_phase)):
        if name in phases:
            t0 = time.monotonic()
            launches[path], out[name] = fn(torch, counters)
            log(f"{name} phase: {time.monotonic() - t0:.1f} s")

    if not skipped:
        out["kernels"] = summarize(results, launches)
    out["seconds"] = time.monotonic() - t_start
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(out, f, indent=1)
    log(f"total {out['seconds']:.1f} s")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    if skipped:
        # A partial run: no kernel summary (it needs every phase), and a
        # last line that names what was skipped.
        print(json.dumps({"ok": True, "partial": True, "phases": phases,
                          "skipped": skipped, "device": device}))
        return 0
    print(json.dumps({"kernels": out["kernels"]}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
