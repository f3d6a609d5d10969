#!/usr/bin/env python3
"""Sweep of the port's bf16 whole-S attention, `attn_stats_wgmma` and
`attn_apply_wgmma` (csrc/attention.cu), on one NVIDIA GPU.

    python3 tools/torch_attention_tiles.py [--rates]

Builds tools/torch_attention_tiles.cu (attention.cu with its two passes
exported one at a time) with the port's nvcc flags and prints the
kernels' registers and spills. Then, at every whole-S shape of the
flagship 128x128 and the SR 256x256 U-Net (batch 16) and chip_smoke.py's
EXTRA_SHAPES, on both softmax axes: `fused_attention` against
`attention_reference` (and against the wrong axis, which must fail); the
stats pass against plain (m, l) at each ring depth; the apply at each
column split and ring depth it admits, each held to the reference; the
device time of each (CUDA events over back-to-back launches) beside
SDPA's on the key axis; and the sums per flagship and per SR call of the
variants attention.cu takes, and each pass at attention.cu's choices
with every TMA box zero-filled (`no memory`: the rings and the products
alone). First, the rate of wgmma issue patterns with no memory traffic
(m64nNk16 for N = 32 to 256, one to four independent accumulators,
interleaved or chain by chain, B K-major or MN-major, one or two
warpgroups a block on every SM), and the library's SASS into
chiprun_out/attention_tiles.sass where cuobjdump is found. Every check
runs before the script fails, so one call shows them all; `--rates`
stops after the rates. Exits 2 without a CUDA device, 1 on any failed
check.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

# (S, D) of the whole-S attention blocks (chip_smoke.py BLOCK_SHAPES, the
# SR_BLOCK_SHAPES that do not stream, EXTRA_SHAPES).
FLAGSHIP = [(1024, 512), (256, 512), (64, 1024), (256, 1024)]
SR = [(1024, 512), (256, 1024), (1024, 1024)]
EXTRA = [(256, 128), (256, 384), (1024, 768), (64, 128)]
BATCH = 16
QK_STD = 1.5
LOG2E = 1.4426950408889634
STATS_STAGES = (0, 2, 4)        # 0: attention.cu's depth
APPLY_SPLITS = (0, 1, 2, 4, 8)  # 0: wgmma_plan's split
APPLY_STAGES = (0, 8)


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


def plain_stats(torch, q, k, scale, axis):
    """(m, l) of the kept rows, (N*H, S) fp32, from fp32 scores."""
    qh, kh = (t.permute(0, 2, 1, 3).float() for t in (q, k))
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale     # (N, H, Sq, Sk)
    dim = -2 if axis == "q" else -1
    m = s.amax(dim)
    l = torch.exp(s - m.unsqueeze(dim)).sum(dim)
    return m.flatten(0, 1), l.flatten(0, 1)


def main() -> int:
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("torch_attention_tiles: no CUDA device", file=sys.stderr)
        return 2
    from sdm_tpu_torch.kernels import _build
    from sdm_tpu_torch.kernels.attention import (attention_reference,
                                                 fused_attention, wgmma_plan,
                                                 wgmma_stages)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(_build.BUILD_DIR, "libtorch_attention_tiles.so")
    built = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", lib_path,
                            os.path.join(HERE, "torch_attention_tiles.cu")],
                           capture_output=True, text=True)
    if built.returncode != 0:
        print(built.stdout + built.stderr, file=sys.stderr)
        return 1
    name = None
    for line in (built.stdout + built.stderr).splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            name = m.group(1)
        elif name and "wgmma" in name and ("registers" in line
                                           or "spill" in line):
            print(f"ptxas: {name}: {line.strip()}")
        if "warning" in line.lower() or "serializ" in line:
            print(f"ptxas: {line.strip()}")
    lib = ctypes.CDLL(lib_path)
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tiles_attention_stats.argtypes = [P, P, P, I, I, I, I, Fl, I, I, I,
                                          P, P, P]
    lib.tiles_attention_apply.argtypes = [P, P, P, P, P, I, I, I, I, Fl, I,
                                          I, I, I, P, P, P]
    lib.tiles_wgmma_rate.argtypes = [I, I, I, I, P, P, P]
    lib.tiles_wgmma_rate_name.argtypes = [I]
    lib.tiles_wgmma_rate_name.restype = ctypes.c_char_p
    for fn in (lib.tiles_attention_stats, lib.tiles_attention_apply,
               lib.tiles_wgmma_rate):
        fn.restype = I
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    if os.path.exists(cuobjdump):
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "attention_tiles.sass"),
                  "w") as f:
            subprocess.run([cuobjdump, "-sass", lib_path], stdout=f,
                           stderr=subprocess.STDOUT)
        sass_summary(os.path.join("chiprun_out", "attention_tiles.sass"))
        linear = _build.build(["linear"])["linear"]
        with open(os.path.join("chiprun_out", "linear.sass"), "w") as f:
            subprocess.run([cuobjdump, "-sass", linear], stdout=f,
                           stderr=subprocess.STDOUT)
        sass_summary(os.path.join("chiprun_out", "linear.sass"))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    rates(torch, lib, dev)
    tma_rates(torch, lib, dev)
    if sys.argv[1:] == ["--rates"]:
        return 0
    failed = []
    sums = {}   # (model, axis) -> [wrapper, stats, apply, sdpa] ms

    def check(what, got, want):
        err = (got.float() - want.float()).abs()
        bound = 1e-2 * want.float().abs() + 1e-2 * want.float().abs().max()
        ok = bool(torch.isfinite(got.float()).all()) and bool(
            (err <= bound).all())
        if not ok:
            failed.append(what)
        return ok, err.max().item()

    shapes = {}
    for model, blocks in (("flagship", FLAGSHIP), ("sr", SR),
                          ("extra", EXTRA)):
        for sh in blocks:
            shapes.setdefault(sh, []).append(model)
    for (s_len, d), models in shapes.items():
        qkv = (torch.randn((BATCH, s_len, 1, 3 * d), generator=gen,
                           device=dev) * QK_STD).to(bf)
        q, k, v = qkv.split(d, dim=-1)
        v = v / QK_STD
        scale = d ** -0.5
        strides = (ctypes.c_longlong * 12)(*[
            x for t in (q, k, v, q)
            for x in (t.stride(0), t.stride(2), t.stride(1))])
        out = torch.empty((BATCH, s_len, 1, d), dtype=bf, device=dev)
        ostrides = (ctypes.c_longlong * 12)(*[
            x for t in (q, k, v, out)
            for x in (t.stride(0), t.stride(2), t.stride(1))])
        stream = torch.cuda.current_stream().cuda_stream
        for axis in ("q", "k"):
            aq = int(axis == "q")
            tag = f"S={s_len} D={d} {axis}"
            want = attention_reference(q, k, v, scale, axis)
            got = fused_attention(q, k, v, scale, axis)
            ok, err = check(f"fused_attention {tag}", got, want)
            wrong = attention_reference(q, k, v, scale,
                                        "k" if axis == "q" else "q")
            wrong_ok = not check(f"wrong axis {tag}", got, wrong)[0]
            if wrong_ok:
                failed.pop()   # the wrong axis failing is the point
            else:
                failed.append(f"wrong axis passes {tag}")
            ms_wrapper = time_ms(torch, lambda: fused_attention(
                q, k, v, scale, axis))
            line = (f"{tag} ({'+'.join(models)}): fused_attention "
                    f"{'ok' if ok else 'FAILED'} max abs err {err:.3e}, "
                    f"wrong axis {'fails' if wrong_ok else 'PASSES'}; "
                    f"{ms_wrapper:.4f} ms")
            if axis == "k":
                qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
                ms_sdpa = time_ms(torch, lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, scale=scale))
                line += f"; SDPA {ms_sdpa:.4f}"
            print(line, flush=True)

            m_want, l_want = plain_stats(torch, q, k, scale, axis)
            stats = torch.empty(2 * BATCH * s_len, dtype=torch.float32,
                                device=dev)
            m, l = stats[:BATCH * s_len], stats[BATCH * s_len:]
            st_times = {}
            for stages in STATS_STAGES:
                def run_stats():
                    return lib.tiles_attention_stats(
                        q.data_ptr(), k.data_ptr(), strides, BATCH, 1,
                        s_len, d, scale, aq, stages, 0, m.data_ptr(),
                        l.data_ptr(), stream)
                stats.fill_(float("nan"))
                rc = run_stats()
                torch.cuda.synchronize()
                if rc == -1:
                    continue
                # The kernel keeps m in the log2 scale (max of s log2(e)).
                ok_m = torch.allclose(m, m_want.flatten() * LOG2E,
                                      rtol=1e-5, atol=1e-4)
                ok_l = torch.allclose(l, l_want.flatten(), rtol=1e-4,
                                      atol=0)
                if rc != 0 or not (ok_m and ok_l):
                    failed.append(f"stats {tag} stages {stages} rc {rc}")
                st_times[stages] = time_ms(torch, run_stats)
            # The apply from the right stats, each variant held to the
            # reference.
            nomem_stats = time_ms(torch, lambda: lib.tiles_attention_stats(
                q.data_ptr(), k.data_ptr(), strides, BATCH, 1, s_len, d,
                scale, aq, 0, 1, m.data_ptr(), l.data_ptr(), stream))
            nomem_apply = time_ms(torch, lambda: lib.tiles_attention_apply(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                ostrides, BATCH, 1, s_len, d, scale, aq, 0, 0, 1,
                m.data_ptr(), l.data_ptr(), stream))
            lib.tiles_attention_stats(q.data_ptr(), k.data_ptr(), strides,
                                      BATCH, 1, s_len, d, scale, aq, 0, 0,
                                      m.data_ptr(), l.data_ptr(), stream)
            ap_times = {}
            for split in APPLY_SPLITS:
                for stages in APPLY_STAGES:
                    def run_apply():
                        return lib.tiles_attention_apply(
                            q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), ostrides, BATCH, 1, s_len, d,
                            scale, aq, split, stages, 0, m.data_ptr(),
                            l.data_ptr(), stream)
                    out.fill_(float("nan"))
                    rc = run_apply()
                    torch.cuda.synchronize()
                    if rc == -1:
                        continue
                    ok_a, err_a = check(f"apply {tag} split {split} "
                                        f"stages {stages}", out, want)
                    if rc != 0:
                        failed.append(f"apply {tag} split {split} rc {rc}")
                    ap_times[(split, stages)] = (time_ms(torch, run_apply),
                                                 ok_a, err_a)
            plan = wgmma_plan(BATCH, s_len, d)
            print(f"  stats (ring stages: ms; attention.cu "
                  f"{wgmma_stages(d)[0]}): " + "  ".join(
                      f"{k_ or 'default'}: {t:.4f}"
                      for k_, t in st_times.items()))
            print(f"  apply (split, stages: ms; wgmma_plan {plan}, "
                  f"{wgmma_stages(d)[1]} stages): " + "  ".join(
                      f"({sp or 'plan'}, {st or 'default'}): {t:.4f}"
                      f"{'' if ok_a else ' FAILED'}"
                      for (sp, st), (t, ok_a, _) in ap_times.items()),
                  flush=True)
            print(f"  no memory: stats {nomem_stats:.4f}  apply "
                  f"{nomem_apply:.4f}", flush=True)
            for model in models:
                acc = sums.setdefault((model, axis), [0.0] * 4)
                acc[0] += ms_wrapper
                acc[1] += st_times.get(0, float("nan"))
                acc[2] += ap_times.get((0, 0), (float("nan"),))[0]
                acc[3] += ms_sdpa if axis == "k" else 0.0
        del qkv, q, k, v, out
        torch.cuda.empty_cache()
    for (model, axis), (w, st, ap, sd) in sums.items():
        if model == "extra":
            continue
        print(f"per {model} call, {axis} axis: fused_attention {w:.4f} ms "
              f"(stats {st:.4f} + apply {ap:.4f})"
              + (f"; SDPA {sd:.4f}" if axis == "k" else ""))
    if failed:
        print(f"FAILED: {failed}")
        return 1
    print("every check passed")
    return 0


def sass_summary(path):
    """Per kernel of the SASS: its HGMMA count and its full waits
    (WARPGROUP.DEPBAR.LE gsb0, 0x0). Where ptxas serialized the wgmma
    pipeline there is one such wait after every HGMMA."""
    counts, name = {}, None
    with open(path) as f:
        for line in f:
            m = re.search(r"Function : (\S+)", line)
            if m:
                name = m.group(1)
                counts[name] = [0, 0]
            elif name and "HGMMA" in line:
                counts[name][0] += 1
            elif name and "DEPBAR.LE gsb0, 0x0" in line:
                counts[name][1] += 1
    for name, (hgmma, waits) in counts.items():
        if hgmma:
            print(f"sass: {name[:72]}: {hgmma} HGMMA, {waits} full waits")


def tma_rates(torch, lib, dev, blocks=132, boxes=2000):
    """TB/s the ring delivers from a (16, 1024, 1, 512) view of a qkv
    buffer (row stride 1536) in loads of one, two or four 64-column chunks
    at each ring depth, with and without four m64n64k16 a chunk in each
    consumer warpgroup."""
    lib.tiles_tma_rate.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_int,
                                   ctypes.c_longlong, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p, ctypes.c_void_p]
    lib.tiles_tma_rate.restype = ctypes.c_int
    lib.tiles_tma_rate_name.argtypes = [ctypes.c_int]
    lib.tiles_tma_rate_name.restype = ctypes.c_char_p
    x = torch.randn((16, 1024, 1, 1536), device=dev).to(torch.bfloat16)
    sink = torch.zeros(288, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    v = 0
    while lib.tiles_tma_rate_name(v):
        name = lib.tiles_tma_rate_name(v).decode()
        rows = 64
        chunks = int(re.search(r"of (\d+) chunks", name).group(1))
        line = []
        for stages in (2, 4, 8, 16):
            if stages * rows * 128 * chunks > 200000:
                continue
            def run():
                return lib.tiles_tma_rate(v, x.data_ptr(), 1024, 512, 1536,
                                          boxes, stages, blocks,
                                          sink.data_ptr(), stream)
            rc = run()
            if rc != 0:
                line.append(f"{stages} stages: rc {rc}")
                continue
            ms = time_ms(torch, run, reps=3)
            nbytes = blocks * boxes * rows * 128 * chunks
            extra = ""
            if "wgmma True" in name:
                flop = blocks * boxes * chunks * 2 * 2.0 * 64 * 64 * 64
                extra = f" ({flop / ms / 1e9:.0f} TFLOP/s)"
            line.append(f"{stages} stages {nbytes / ms / 1e9:.2f} TB/s"
                        + extra)
        print(f"tma rate {name}: "
              + ", ".join(line), flush=True)
        v += 1


def rates(torch, lib, dev, blocks=132, rounds=4000):
    """TFLOP/s of each wgmma issue pattern, one and two warpgroups a block,
    one block an SM, no memory traffic."""
    sink = torch.zeros(256, device=dev)
    flop = ctypes.c_double()
    stream = torch.cuda.current_stream().cuda_stream
    v = 0
    while lib.tiles_wgmma_rate_name(v):
        line = []
        for wgs in (1, 2):
            def run():
                return lib.tiles_wgmma_rate(v, wgs, rounds, blocks,
                                            sink.data_ptr(),
                                            ctypes.byref(flop), stream)
            if run() != 0:
                line.append(f"{wgs} warpgroups: launch failed")
                continue
            ms = time_ms(torch, run, reps=3)
            line.append(f"{wgs} warpgroup{'s' if wgs > 1 else ''} "
                        f"{flop.value * blocks / ms / 1e9:.0f} TFLOP/s")
        print(f"wgmma rate {lib.tiles_wgmma_rate_name(v).decode()}: "
              + ", ".join(line), flush=True)
        v += 1


if __name__ == "__main__":
    sys.exit(main())
