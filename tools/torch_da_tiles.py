#!/usr/bin/env python3
"""Tiling sweep of the streaming backward's dK and dQ kernel,
`stream_da_mma` (csrc/streaming_attention.cu), on one NVIDIA GPU.

    python3 tools/torch_da_tiles.py

Builds tools/torch_da_tiles.cu (the tilings of stream_da_mma's template:
32 own rows with 32-row streamed tiles, or 64 with 16-row tiles, each with
the score tiles over all of D or split in two D halves) with the port's nvcc
flags and prints each instantiation's registers and spills. Each variant is
held to the plain versions of dK and dQ on the key axis at (16, 1024, 512)
bf16 (the bound of chip_smoke.py's BWD_TOL), then timed (CUDA events) at
the SR model's streaming shape, (16, 4096, 512) bf16, on both softmax axes,
beside the wrappers `streaming_dk` / `streaming_dq` (the tiling the port
launches) and the operations bound. Exits 2 without a CUDA device.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

BATCH = 16
# chip_smoke.py BWD_TOL["bfloat16"]: |got - plain| <= rtol |plain| +
# of_max max|plain|.
RTOL = OF_MAX = 2e-2
PEAK_BF16 = 989e12   # H100 SXM dense bf16 FLOP/s


def time_ms(torch, fn, reps=10):
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_da_tiles: no CUDA device", file=sys.stderr)
        return 2
    from sdm_tpu_torch.kernels import _build
    from sdm_tpu_torch.kernels import streaming_attention as sa
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(_build.BUILD_DIR, "libtorch_da_tiles.so")
    built = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", lib_path,
                            os.path.join(HERE, "torch_da_tiles.cu")],
                           capture_output=True, text=True)
    if built.returncode != 0:
        print(built.stdout + built.stderr, file=sys.stderr)
        return 1
    name = None
    for line in (built.stdout + built.stderr).splitlines():
        m = (re.search(r"Compiling entry function '([^']+)'", line)
             or re.search(r"Function properties for (\S+)", line))
        if m:
            name = m.group(1) if "stream_da_mma" in m.group(1) else None
        elif name and ("registers" in line or "spill" in line):
            print(f"ptxas {name}: {line.strip()}")
    lib = ctypes.CDLL(lib_path)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.tiles_da.argtypes = [I, P, P, P, P, P, P, I, I, I, ctypes.c_float, I,
                             P, P, P, P]
    lib.tiles_da.restype = I
    lib.tiles_da_name.argtypes = [I]
    lib.tiles_da_name.restype = ctypes.c_char_p
    variants = []
    while lib.tiles_da_name(len(variants)):
        variants.append(lib.tiles_da_name(len(variants)).decode())
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    print(f"the port launches DA_BM={sa.DA_BM} DA_BN={sa.DA_BN} "
          f"DA_KSPLIT={sa.DA_KSPLIT}")
    for i, v in enumerate(variants):
        print(f"v{i}: {v}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream

    def randn(s, d, std):
        return (torch.randn((BATCH, s, d), generator=gen, device=dev)
                * std).to(torch.bfloat16)

    for s_len, d, axes, check in ((1024, 512, ("k",), True),
                                  (4096, 512, ("q", "k"), False)):
        q, k = randn(s_len, d, 1.5), randn(s_len, d, 1.5)
        v, g = randn(s_len, d, 1.0), randn(s_len, d, 1.0)
        scale = d ** -0.5
        bound = 6.0 * BATCH * s_len * s_len * d / PEAK_BF16 * 1e3
        for axis in axes:
            m, l = sa.streaming_stats(q, k, scale, axis)
            out32 = sa.streaming_apply(q, k, v, m, l, scale, axis,
                                       out_dtype=torch.float32)
            dv = sa.streaming_dv(q, k, g, m, l, scale, axis)
            corr = sa.streaming_correction(g, v, out32, dv, axis).contiguous()
            out = torch.empty((BATCH, s_len, d), dtype=torch.float32,
                              device=dev)
            roles = {"dq": ((q, g, k, v), int(axis == "q"),
                            sa.streaming_dq, sa.streaming_dq_reference),
                     "dk": ((k, v, q, g), int(axis != "q"),
                            sa.streaming_dk, sa.streaming_dk_reference)}
            for pname, (ops, stat_col, wrapper, plain) in roles.items():
                strides = (ctypes.c_longlong * 10)(*[
                    x for t in (*ops, out) for x in (t.stride(0),
                                                     t.stride(1))])

                def call(vi):
                    return lib.tiles_da(
                        vi, *(t.data_ptr() for t in ops), out.data_ptr(),
                        ctypes.cast(strides, P), BATCH, s_len, d, scale,
                        stat_col, m.data_ptr(), l.data_ptr(),
                        corr.data_ptr(), stream)
                args = (q, k, v, g, m, l, corr, scale, axis)
                want = plain(*args) if check else None
                times = []
                for vi in range(len(variants)):
                    rc = call(vi)
                    torch.cuda.synchronize()
                    if rc != 0:
                        raise AssertionError(f"v{vi} {pname}: rc {rc}")
                    if check:
                        diff = (out - want).abs()
                        lim = RTOL * want.abs() + OF_MAX * want.abs().max()
                        if not torch.isfinite(out).all() or (diff > lim).any():
                            raise AssertionError(
                                f"v{vi} {pname} S={s_len} {axis}: max abs "
                                f"err {diff.max().item():.3e} past BWD_TOL")
                    times.append(time_ms(torch, lambda: call(vi)))
                port = time_ms(torch, lambda: wrapper(*args))
                print(f"{pname} S={s_len} D={d} {axis}: port {port:.4f} ms  "
                      + "  ".join(f"v{vi} {t:.4f}" for vi, t in
                                  enumerate(times))
                      + f"  (bound {bound:.4f}, operations"
                      + (", held to the plain version" if check else "")
                      + ")")
            del m, l, out32, dv, corr, out
        del q, k, v, g
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
