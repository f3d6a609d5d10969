#!/usr/bin/env python3
"""Tile sweep of the port's bf16 GEMM, `linear_wgmma` (csrc/linear.cu), on
one NVIDIA GPU.

    python3 tools/torch_linear_tiles.py

Builds tools/torch_linear_tiles.cu (instantiations of linear_wgmma's
template: block tiles of one or two consumer warpgroups by BN 64, 128 or
256, 3 to 5 ring stages, one or two blocks an SM) with the port's nvcc
flags and prints each variant's registers and spills. Then it holds each
variant to `linear_reference` (max abs error within 1e-2 of the largest
output) at every bf16 projection of the flagship 128x128 and the SR
256x256 U-Net (batch 16, with the residual epilogue) and off the grid
(ragged M = 300, N = 200 and odd N = 197, K = 520 with its 8-column tail),
and prints its mean device time (CUDA events, bias only) and TFLOP/s
beside F.linear's (cuBLAS) on the same inputs, the sums per flagship and
per SR call, each variant's time with every TMA box zero-filled
(`no_memory`: the ring and the wgmma alone) at the largest square
projection, and the variants csrc/linear.cu launches (`linear_wgmma_tile`)
at each shape. Last, `linear` itself (the port's wrapper: checks, the
output's allocation, the TMA maps, the launch) at each projection: CUDA
events around back-to-back calls as chip_smoke.py times it, the same with
the stream held by a sleep kernel until every call is queued (the device
time alone), and the host's microseconds a call. Exits 2 without a CUDA
device.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

# (S, C) of the attention blocks (chip_smoke.py BLOCK_SHAPES,
# SR_BLOCK_SHAPES); each runs (16 S, 3 C, C) and (16 S, C, C).
FLAGSHIP = [(1024, 512), (256, 512), (64, 1024), (256, 1024)]
SR = [(4096, 512), (1024, 512), (256, 1024), (1024, 1024)]
BATCH = 16
# Off the U-Net's grid: (M, N, K).
OFF_GRID = [(300, 200, 512), (300, 197, 520)]


def time_ms(torch, fn, reps=20):
    for _ in range(3):
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


def main() -> int:
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("torch_linear_tiles: no CUDA device", file=sys.stderr)
        return 2
    from sdm_tpu_torch.kernels import _build
    from sdm_tpu_torch.kernels.attention_block import (LINEAR_TILES,
                                                       linear_reference,
                                                       linear_wgmma_tile)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(_build.BUILD_DIR, "libtorch_linear_tiles.so")
    built = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", lib_path,
                            os.path.join(HERE, "torch_linear_tiles.cu")],
                           capture_output=True, text=True)
    if built.returncode != 0:
        print(built.stdout + built.stderr, file=sys.stderr)
        return 1
    for line in (built.stdout + built.stderr).splitlines():
        if re.search(r"linear_wgmma|registers|spill", line) and (
                "registers" in line or "spill" in line
                or "Compiling entry" in line):
            print("ptxas:", line.strip())
    lib = ctypes.CDLL(lib_path)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.tiles_linear.argtypes = [I, I, P, P, P, I, P, P, I, I, I, P]
    lib.tiles_linear.restype = I
    lib.tiles_linear_name.argtypes = [I]
    lib.tiles_linear_name.restype = ctypes.c_char_p
    variants = []
    while lib.tiles_linear_name(len(variants)):
        variants.append(lib.tiles_linear_name(len(variants)).decode())
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    for i, name in enumerate(variants):
        print(f"v{i}: {name}")
    print(f"linear.cu's tiles (warpgroups, BN, stages): {LINEAR_TILES}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    shapes = {}
    for model, blocks in (("flagship", FLAGSHIP), ("sr", SR)):
        for s, c in blocks:
            for n in (3 * c, c):
                shapes.setdefault((BATCH * s, n, c), []).append(model)
    for shape in OFF_GRID:
        shapes[shape] = []
    sums = {m: [0.0] * (len(variants) + 1) for m in ("flagship", "sr")}
    for (m, n, k), models in shapes.items():
        x = (torch.randn((m, k), generator=gen, device=dev) * 1.5).to(bf)
        w = (torch.randn((n, k), generator=gen, device=dev) / k ** 0.5).to(bf)
        b = (torch.randn((n,), generator=gen, device=dev) * 0.1).to(bf)
        res = torch.randn((m, n), generator=gen, device=dev).to(bf)
        y = torch.empty((m, n), dtype=bf, device=dev)
        want = linear_reference(x, w, b, res).float()
        stream = torch.cuda.current_stream().cuda_stream

        def call(v, r, no_memory=0):
            return lib.tiles_linear(v, no_memory, x.data_ptr(), w.data_ptr(),
                                    b.data_ptr(), 1, r, y.data_ptr(), m, n,
                                    k, stream)
        errs = []
        for v in range(len(variants)):
            y.fill_(float("nan"))
            rc = call(v, res.data_ptr())
            torch.cuda.synchronize()
            err = (y.float() - want).abs().max().item()
            errs.append(err)
            if rc != 0 or not err <= 1e-2 * want.abs().max().item():
                raise AssertionError(f"v{v} at {m}x{n}x{k}: rc {rc}, max "
                                     f"abs err {err}")
        if not models:
            print(f"M={m} N={n} K={k} (off grid): every variant within "
                  f"{max(errs):.3e} of the plain version (largest output "
                  f"{want.abs().max().item():.3e})")
            continue
        times = [time_ms(torch, lambda: F.linear(x, w, b))]
        times += [time_ms(torch, lambda: call(v, None))
                  for v in range(len(variants))]
        for model in models:
            sums[model] = [a + t for a, t in zip(sums[model], times)]
        tflop = 2.0 * m * n * k / 1e9
        best = min(range(len(variants)), key=lambda v: times[v + 1])
        print(f"M={m} N={n} K={k} ({'+'.join(models)}): linear.cu takes "
              f"tile {linear_wgmma_tile(m, n)}; F.linear {times[0]:.4f} ms "
              f"({tflop / times[0]:.0f} TFLOP/s)  " + "  ".join(
                  f"v{v} {t:.4f} ({tflop / t:.0f})"
                  for v, t in enumerate(times[1:]))
              + f"  best v{best}; max abs err {max(errs):.3e}")
        if (m, n, k) == (BATCH * 1024, 3 * 1024, 1024):
            nomem = [time_ms(torch, lambda: call(v, None, 1))
                     for v in range(len(variants))]
            print(f"M={m} N={n} K={k} with no memory traffic: " + "  ".join(
                f"v{v} {t:.4f} ms ({tflop / t:.0f} TFLOP/s)"
                for v, t in enumerate(nomem)))
        del x, w, b, res, y, want
    for model, t in sums.items():
        print(f"per {model} call (both projections of every block): "
              f"F.linear {t[0]:.4f} ms  " +
              "  ".join(f"v{v} {s:.4f}" for v, s in enumerate(t[1:])))
    wrapper(torch, gen, [s for s, models in shapes.items() if models])
    return 0


def wrapper(torch, gen, shapes, reps=50):
    """`linear` through its wrapper at each shape: back-to-back events, the
    device time with every call queued behind a sleep kernel, host us."""
    from sdm_tpu_torch.kernels.attention_block import linear
    dev, bf = torch.device("cuda"), torch.bfloat16
    sums = [0.0, 0.0]
    for m, n, k in shapes:
        x = torch.randn((m, k), generator=gen, device=dev).to(bf)
        w = (torch.randn((n, k), generator=gen, device=dev) / k ** 0.5).to(bf)
        b = torch.randn((n,), generator=gen, device=dev).to(bf)
        back_to_back = time_ms(torch, lambda: linear(x, w, b), reps)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)   # tens of ms: every call queues
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            linear(x, w, b)
        host_us = (time.perf_counter() - t0) / reps * 1e6
        end.record()
        end.synchronize()
        queued = start.elapsed_time(end) / reps
        sums[0] += back_to_back
        sums[1] += queued
        print(f"linear() M={m} N={n} K={k}: back to back {back_to_back:.4f} "
              f"ms, queued (device) {queued:.4f} ms, host {host_us:.1f} us "
              "a call")
    print(f"linear() summed over those shapes: back to back {sums[0]:.4f} "
          f"ms, queued {sums[1]:.4f} ms")


if __name__ == "__main__":
    sys.exit(main())
