#!/usr/bin/env python3
"""Tile sweep of the port's bf16 GEMM, `linear_mma` (csrc/linear.cu), on
one NVIDIA GPU.

    python3 tools/torch_linear_tiles.py

Builds tools/torch_linear_tiles.cu (a few instantiations of linear_mma's
template; variant 0 is the 128 x 128 tile `linear` launches, 1 its small
tile) with the port's nvcc flags, holds each variant to `linear_reference`
at every bf16 projection of the flagship 128x128 and the SR 256x256 U-Net
(batch 16, with the residual epilogue), and prints its mean device time
(CUDA events, bias only) beside F.linear's (cuBLAS) on the same inputs,
the sums per flagship and per SR call, and each variant's time with every
global load zero-filled (`no_memory`: the mma.sync pipeline alone). Exits
2 without a CUDA device.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

# (S, C) of the attention blocks (chip_smoke.py BLOCK_SHAPES,
# SR_BLOCK_SHAPES); each runs (16 S, 3 C, C) and (16 S, C, C).
FLAGSHIP = [(1024, 512), (256, 512), (64, 1024), (256, 1024)]
SR = [(4096, 512), (1024, 512), (256, 1024), (1024, 1024)]
BATCH = 16


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
    from sdm_tpu_torch.kernels.attention_block import linear_reference
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(_build.BUILD_DIR, "libtorch_linear_tiles.so")
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", lib_path,
                    os.path.join(HERE, "torch_linear_tiles.cu")], check=True,
                   capture_output=True)
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
    for i, name in enumerate(variants):
        print(f"v{i}: {name}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    shapes = {}
    for model, blocks in (("flagship", FLAGSHIP), ("sr", SR)):
        for s, c in blocks:
            for n in (3 * c, c):
                shapes.setdefault((BATCH * s, n, c), []).append(model)
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
        times = [time_ms(torch, lambda: F.linear(x, w, b))]
        for v in range(len(variants)):
            rc = call(v, res.data_ptr())
            torch.cuda.synchronize()
            err = (y.float() - want).abs().max().item()
            if rc != 0 or err > 1e-2 * want.abs().max().item():
                raise AssertionError(f"v{v} at {m}x{n}x{k}: rc {rc}, max "
                                     f"abs err {err}")
            times.append(time_ms(torch, lambda: call(v, None)))
        for model in models:
            sums[model] = [a + t for a, t in zip(sums[model], times)]
        tflops = 2.0 * m * n * k / 1e9
        print(f"M={m} N={n} K={k} ({'+'.join(models)}): F.linear "
              f"{times[0]:.4f} ms ({tflops / times[0]:.0f} TFLOP/s)  " +
              "  ".join(f"v{v} {t:.4f}" for v, t in enumerate(times[1:])))
        if (m, n, k) == (BATCH * 1024, 3 * 1024, 1024):
            nomem = [time_ms(torch, lambda: call(v, None, 1))
                     for v in range(len(variants))]
            print(f"M={m} N={n} K={k} with no memory traffic: " + "  ".join(
                f"v{v} {t:.4f} ms ({tflops / t:.0f} TFLOP/s)"
                for v, t in enumerate(nomem)))
        del x, w, b, res, y, want
    for model, t in sums.items():
        print(f"per {model} call (both projections of every block): "
              f"F.linear {t[0]:.4f} ms  " +
              "  ".join(f"v{v} {s:.4f}" for v, s in enumerate(t[1:])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
