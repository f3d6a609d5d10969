#!/usr/bin/env python3
"""Sweep of the port's bf16 AdaGN forward (csrc/adagn.cu) on one NVIDIA GPU.

    python3 tools/torch_adagn_tiles.py [--quick]

Builds tools/torch_adagn_tiles.cu (adagn.cu with its route left open) with
the port's nvcc flags, once with the library's settings and once for each
other setting swept (-DADAGN_PIECE, -DADAGN_SLOTS, -DADAGN_TEAM_BYTES: 16-64
KB bulk copies, 2-6 ring slots, samples in flight of one team to one team a
sample), all builds at once, and prints the one-pass kernel's registers
and spills in each. Then at each of the 14 (H, W, C) AdaGN shapes of the
flagship 128x128 and the SR 256x256 U-Net, batch 16, bf16, G = 32: the
entry point's plan against `adagn_reference` (within chip_smoke.py's bf16
tolerance) and twice for identical bits; the two passes and the one-pass
kernel of each build, each checked and timed queued behind a sleep kernel
(device time, no host time); the two-pass kernels against the entry
point's plan in one call, old, new, new, old, so that drift between calls
cannot pass for a gain; beside the bound (x read and the output written
once at 3.35 TB/s) and F.group_norm + FiLM. The entry point's plan is also
checked at batch 1, 2, 8 and 32, at an input mean of 50 and with
per-sample FiLM rows. `--quick` runs the checks alone (a new kernel's
first call); `--profile` reads the kernels' device time by the profiler
beside the host's time a call. Every check runs before the script fails;
per-shape results go to chiprun_out/adagn_tiles.json. Exits 2 without a
CUDA device, 1 on any failed check.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

SHAPES = [(128, 128, 128), (64, 64, 256), (32, 32, 512), (16, 16, 512),
          (8, 8, 1024), (16, 16, 1024), (32, 32, 768), (64, 64, 384),
          (256, 256, 128), (128, 128, 256), (64, 64, 512), (32, 32, 1024),
          (64, 64, 1024), (128, 128, 512)]
BATCH = 16
GROUPS = 32
TOL = dict(atol=2e-2, rtol=2e-2)     # chip_smoke.py's bf16 AdaGN TOL
PEAK_BYTES = 3.35e12
# The one-pass settings swept, each a build: (bulk-copy bytes, ring slots)
# at the library's teams, then the bytes of the samples in flight (1: one
# team; 1 TiB: one team a sample) at the library's ring. {} is the
# library's own (65536, 3, 64 MiB).
SETTINGS = ([{}] + [dict(ADAGN_PIECE=p, ADAGN_SLOTS=sl) for p, sl in
                    ((16384, 4), (32768, 4), (32768, 6), (65536, 2))]
            + [dict(ADAGN_TEAM_BYTES=tb) for tb in
               (1, 16 << 20, 32 << 20, 128 << 20, 1 << 40)])
REPS = 20


def setting_name(setting):
    if not setting:
        return "library (piece 64K, 3 slots, team bytes 64M)"
    if "ADAGN_PIECE" in setting:
        return (f"piece {setting['ADAGN_PIECE'] // 1024}K, "
                f"{setting['ADAGN_SLOTS']} slots")
    tb = setting["ADAGN_TEAM_BYTES"]
    return f"team bytes {tb if tb < 1024 else f'{tb >> 20}M'}"


def queued_ms(torch, fn, reps=REPS):
    """Mean device ms of fn over `reps` launches queued behind a sleep
    kernel, so that the host's time per call drops out."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def build_all(nvcc, flags, src, build_dir):
    """One nvcc a setting, all started at once; [(lib path, rc, log)]."""
    procs = []
    for i, setting in enumerate(SETTINGS):
        out = os.path.join(build_dir, f"libtorch_adagn_tiles-{i}.so")
        defs = [f"-D{k}={v}" + ("LL" if k == "ADAGN_TEAM_BYTES" else "")
                for k, v in setting.items()]
        procs.append((out, subprocess.Popen(
            [nvcc, *flags, *defs, "-o", out, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    built = []
    for out, proc in procs:
        text = proc.communicate()[0]
        built.append((out, proc.returncode, text))
    return built


def ptxas_lines(text):
    """(kernel, line) for each register or spill line of the one-pass
    kernel."""
    name, out = None, []
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            name = m.group(1)
        elif name and "adagn_grid" in name and (
                "registers" in line or "spill" in line):
            out.append((name, line.strip()))
    return out


def main() -> int:
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("torch_adagn_tiles: no CUDA device", file=sys.stderr)
        return 2
    from sdm_tpu_torch.kernels import _build
    from sdm_tpu_torch.kernels.adagn import adagn_reference
    quick = sys.argv[1:] == ["--quick"]
    profile = sys.argv[1:] == ["--profile"]
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(HERE, "torch_adagn_tiles.cu")
    if quick:
        del SETTINGS[1:]
    built = build_all(_build.nvcc(), _build.NVCC_FLAGS, src, _build.BUILD_DIR)
    failed = []
    libs = []
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for setting, (path, rc, text) in zip(SETTINGS, built):
        if rc != 0:
            print(text, file=sys.stderr)
            return 1
        for name, line in ptxas_lines(text):
            print(f"ptxas: {setting_name(setting)}: {name}: {line}")
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill",
                          line)
            if m and (int(m.group(1)) or int(m.group(2))):
                failed.append(f"{setting_name(setting)}: {name} spills")
        lib = ctypes.CDLL(path)
        lib.tiles_adagn.argtypes = [P, P, P, P, P, P, P, L, P, L, I, I, I, I,
                                    ctypes.c_float, L, I, P, P]
        lib.tiles_adagn.restype = I
        libs.append(lib)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    stream = torch.cuda.current_stream().cuda_stream
    # The partials of any plan at batch 32, and the one pass's counters
    # (zeroed once; every launch leaves them at zero).
    scratch = torch.empty(2 * 32 * 132 * GROUPS, dtype=torch.float32,
                          device=dev)
    counters = torch.zeros(2 * 32, dtype=torch.int64, device=dev)
    plan = (ctypes.c_int * 6)()

    def randn(shape, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * std
                + mean).to(bf)

    def inputs(n, h, w, c, mean=0.5, film_rows=1):
        return (randn((n, h, w, c), 2.0 if mean == 0.5 else 1.0, mean),
                randn((c,), 0.1, 1.0), randn((c,), 0.1),
                randn((film_rows, c), 0.5, 1.0), randn((film_rows, c), 0.5))

    def run(args, out, route=-1, lib=libs[0]):
        """One call of a build (the library's settings unless `lib`) on
        `route` (-1 its entry point's plan)."""
        x, gamma, beta, s, t = args
        n, h, w, c = x.shape
        return lib.tiles_adagn(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), s.data_ptr(),
            t.data_ptr(), out.data_ptr(), scratch.data_ptr(), scratch.numel(),
            counters.data_ptr(), counters.numel(), n, h * w, c, GROUPS, 1e-5,
            0 if s.shape[0] == 1 else s.stride(0), route, plan, stream)

    def check(tag, args, out, want, rc):
        torch.cuda.synchronize()
        if rc != 0:
            failed.append(f"{tag}: rc {rc}")
            return False, float("nan")
        got, ref = out.float(), want.float()
        err = (got - ref).abs()
        ok = bool(torch.isfinite(got).all()) and bool(
            (err <= TOL["atol"] + TOL["rtol"] * ref.abs()).all())
        if not ok:
            failed.append(f"{tag}: max abs err {err.max().item():.3e}")
        return ok, err.max().item()

    def plan_text():
        if plan[0] == 1:
            return (f"one pass, {plan[1]} blocks in {plan[4]} teams, piece "
                    f"{plan[2]} rows, smem {plan[3]}")
        return f"two passes, chunks {plan[5]}"

    results = []
    if profile:
        return profile_routes(torch, run, inputs)
    # The entry point's plan at the other batches, a large mean, and per-
    # sample FiLM rows: checks, and at batch 1 and 2 (fewer rows than SMs
    # at 8x8) also the two passes against it, old, new, new, old, queued.
    for n, h, w, c, mean, rows in ([(n, *sh, 0.5, 1) for n in (1, 2, 8, 32)
                                    for sh in SHAPES]
                                   + [(16, 64, 64, 384, 50.0, 1),
                                      (16, 256, 256, 128, 50.0, 1),
                                      (16, 64, 64, 512, 0.5, 16),
                                      (16, 32, 32, 512, 0.5, 16)]):
        args = inputs(n, h, w, c, mean, rows)
        want = adagn_reference(*args, GROUPS)
        out = torch.empty_like(want)
        ok, err = check(f"entry N={n} {h}x{w}x{c} mean {mean} film {rows}",
                        args, out, want, run(args, out))
        text = plan_text()
        ab = ""
        if n <= 2 and not quick:
            ab = "; old, new, new, old " + " ".join(
                f"{queued_ms(torch, lambda: run(args, out, route=r)):.4f}"
                for r in (0, -1, -1, 0)) + " ms"
        print(f"entry N={n:2d} {h:3d}x{w:3d}x{c:4d} mean {mean:4.1f} film "
              f"rows {rows:2d}: {text}: {'ok' if ok else 'FAILED'} "
              f"(max abs err {err:.3e}){ab}", flush=True)
        del args, want, out

    for h, w, c in SHAPES:
        tag = f"{h}x{w}x{c}"
        args = inputs(BATCH, h, w, c)
        want = adagn_reference(*args, GROUPS)
        out = torch.empty_like(want)
        ok, err = check(f"entry {tag}", args, out, want, run(args, out))
        first = out.clone()
        run(args, out)
        torch.cuda.synchronize()
        same = torch.equal(first, out)
        if not same:
            failed.append(f"entry {tag}: two runs differ")
        entry = plan_text()
        entry_plan = list(plan)
        nbytes = BATCH * h * w * c * 2 * 2 + 4 * c * 2
        bound = nbytes / PEAK_BYTES * 1e3
        print(f"{tag}: entry {entry}: {'ok' if ok else 'FAILED'} (max abs "
              f"err {err:.3e}), two runs {'identical' if same else 'DIFFER'}"
              f"; bound {bound:.4f} ms", flush=True)
        row = dict(shape=[BATCH, h, w, c], entry_plan=entry_plan,
                   max_abs_err=err, identical=same, bound_ms=bound)
        if quick:
            results.append(row)
            continue
        variants = [("two-pass", dict(route=0))]
        variants += [(f"{setting_name(st)}: ", dict(route=1, lib=lib))
                     for st, lib in zip(SETTINGS, libs)]
        times = {}
        for name, kw in variants:
            out.fill_(float("nan"))
            rc = run(args, out, **kw)
            if rc == -1:
                continue
            if not check(f"{name} {tag}", args, out, want, rc)[0]:
                continue
            if kw["route"] == 1:
                name += plan_text()
            times[name] = queued_ms(torch, lambda: run(args, out, **kw))
        old = lambda: run(args, out, route=0)   # noqa: E731
        new = lambda: run(args, out)            # noqa: E731
        ab = [queued_ms(torch, fn) for fn in (old, new, new, old)]
        xc = args[0].permute(0, 3, 1, 2)
        s4, t4 = args[3][:, :, None, None], args[4][:, :, None, None]
        lib_ms = queued_ms(torch, lambda: F.group_norm(xc, GROUPS, args[1],
                                                       args[2]) * s4 + t4)
        best = min(times, key=times.get)
        print(f"{tag}: old, new, new, old {ab[0]:.4f} {ab[1]:.4f} "
              f"{ab[2]:.4f} {ab[3]:.4f} ms; best {best} {times[best]:.4f}; "
              f"group_norm+FiLM {lib_ms:.4f}; bound {bound:.4f}", flush=True)
        for name in sorted(times, key=times.get)[:12]:
            print(f"    {name:40s} {times[name]:.4f} ms "
                  f"({times[name] / bound:.2f}x bound)")
        row.update(ab_ms=ab, variants_ms=times, library_ms=lib_ms)
        results.append(row)
        del args, want, out, first

    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "adagn_tiles.json"), "w") as f:
        json.dump(dict(card=card, results=results, failed=failed), f,
                  indent=1)
    for line in failed:
        print(f"FAILED: {line}")
    return 1 if failed else 0


def profile_routes(torch, run, inputs):
    """Device time of each route's kernels by the profiler (CUPTI), beside
    the host's time of a call and the CUDA-event time of one lone call."""
    import time
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cases = [((64, 64, 512), dict(route=0)), ((64, 64, 512), dict()),
             ((256, 256, 128), dict(route=0)), ((256, 256, 128), dict()),
             ((8, 8, 1024), dict(route=0)), ((8, 8, 1024), dict())]
    for (h, w, c), kw in cases:
        args = inputs(BATCH, h, w, c)
        out = torch.empty_like(args[0])
        for _ in range(3):
            run(args, out, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(args, out, **kw)
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run(args, out, **kw)
        end.record()
        end.synchronize()
        lone = start.elapsed_time(end)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                run(args, out, **kw)
            torch.cuda.synchronize()
        kern = [(e.key, e.self_device_time_total / e.count / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        print(f"{h}x{w}x{c} {kw}: host {host * 1e3:.4f} ms a call, lone "
              f"call (events) {lone:.4f} ms; device: "
              + "; ".join(f"{k[:40]} {ms:.4f} ms x{n}" for k, ms, n in kern),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
