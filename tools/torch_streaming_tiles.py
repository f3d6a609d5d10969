#!/usr/bin/env python3
"""Sweep of the port's bf16 streaming attention forward,
`stream_stats_wgmma` and `stream_apply_wgmma`, and of its dV pass (the
apply kernel with q and k swapped, `stream_apply_wgmma<..., dv_pass>`)
(csrc/streaming_attention.cu), on one NVIDIA GPU.

    python3 tools/torch_streaming_tiles.py [--quick]

Builds tools/torch_streaming_tiles.cu (streaming_attention.cu with its
passes exported one at a time) with the port's nvcc flags, and once more
with the phase clocks (-DSW_PHASE_CLOCKS), and prints each kernel's
registers and spills, any ptxas line on serialized wgmma, and (where
cuobjdump is found) the SASS's HGMMA count and full waits per kernel
(chiprun_out/streaming_tiles.sass). Then at the SR model's (4096, 512) and
at (1024, 512), batch 16, on both softmax axes: the stats pass against
plain (m, l) at 64 and 128 kept rows a block and each ring depth; the
apply (bf16 out, and fp32 out at the entry point's choices) against
`streaming_apply_reference` from the plain stats in loads of four and of
eight chunks at each ring depth, the wrong axis failing; the device time
of each (CUDA events over back-to-back launches); each pass with every
TMA box zero-filled (`no memory`: the rings and the products alone); each
kernel's cycles by phase (thread 0 of every block, the clock build); the
mma.sync kernels the forward ran before (attn_stats_mma<streaming>, whose
source the .cu keeps for this, and stream_apply_mma<..., apply_pass>) in
the same call; and SDPA on the key axis as the library's yardstick. dV,
at the same shapes and axes from the plain stats: the wgmma kernel at the
entry point's choices and through `streaming_dv` (which must count it as
a wgmma launch) against `streaming_dv_reference` with chip_smoke.py's
bf16 BWD_TOL, the wrong axis failing; then the mma.sync kernel it
replaced (stream_apply_mma<float, ..., dv_pass>, tools/torch_mma_sync.cuh)
and the new one old, new, new, old, each load size and ring depth, with
zero-filled boxes, and by phase. `--quick` checks the entry points'
choices alone (the first call of a new kernel). Every check runs before
the script fails. Exits 2 without a CUDA device, 1 on any failed check.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

SHAPES = [(4096, 512), (1024, 512)]
BATCH = 16
QK_STD = 1.5
STATS_KEPT = (64, 128)
STATS_STAGES = (0, 2, 4)     # 0: the most that fit
APPLY_CHUNKS = (4, 8)        # chunks a load
APPLY_STAGES = (0, 2, 3)
# chip_smoke.py BWD_TOL["bfloat16"]: |got - plain| <= rtol |plain| + of_max
# max|plain| (a one-ulp flip of a bf16 P entry, scaled by dV's size).
DV_RTOL = DV_OF_MAX = 2e-2
PEAK_BF16 = 989e12   # H100 SXM dense bf16 FLOP/s
# The clock build's phases (csrc/streaming_attention.cu SW_CLOCK).
PHASES = (("full wait", "wgmma issue + wait<1>", "drain wait<0>",
           "(m, l) merge", "", "", "", ""),
          ("K full wait", "Q K^T issue + wait<1>", "drain wait<0>",
           "P on the fragments", "named barrier", "V full wait",
           "P V issue", "P V retire"))


def main() -> int:
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("torch_streaming_tiles: no CUDA device", file=sys.stderr)
        return 2
    from torch_attention_tiles import sass_summary, time_ms
    from sdm_tpu_torch.kernels import _build
    from sdm_tpu_torch.kernels import streaming_attention as sa
    quick = sys.argv[1:] == ["--quick"]
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(_build.BUILD_DIR, "libtorch_streaming_tiles.so")
    src = os.path.join(HERE, "torch_streaming_tiles.cu")
    # Beside the library as the port builds it, one with the phase clocks.
    variants = {"clocks": "-DSW_PHASE_CLOCKS"}
    paths = {name: os.path.join(_build.BUILD_DIR,
                                f"libtorch_streaming_tiles_{name}.so")
             for name in variants}
    jobs = {name: subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, flag, "-o", paths[name], src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, flag in variants.items()}
    built = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", lib_path,
                            src], capture_output=True, text=True)
    outs = {name: job.communicate()[0] for name, job in jobs.items()}
    if built.returncode != 0 or any(j.returncode for j in jobs.values()):
        print(built.stdout + built.stderr + "".join(outs.values()),
              file=sys.stderr)
        return 1
    failed = []
    name = None
    for line in (built.stdout + built.stderr).splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            name = m.group(1)
        elif name and "wgmma" in name and ("registers" in line
                                           or "spill" in line):
            print(f"ptxas: {name}: {line.strip()}")
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill",
                          line)
            if m and (int(m.group(1)) or int(m.group(2))):
                failed.append(f"{name} spills")
        if "warning" in line.lower() or "serializ" in line:
            print(f"ptxas: {line.strip()}")
            if "serializ" in line and "wgmma" in line:
                failed.append(f"serialized wgmma: {line.strip()}")
    lib = ctypes.CDLL(lib_path)
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tiles_stream_stats.argtypes = [P, P, P, I, I, I, Fl, I, I, I, I, P,
                                       P, P]
    lib.tiles_stream_apply.argtypes = [P, P, P, P, P, I, I, I, Fl, I, I, I,
                                       I, I, P, P, P]
    lib.tiles_stream_stats_mma.argtypes = [P, P, P, I, I, I, Fl, I, P, P, P]
    lib.tiles_stream_apply_mma.argtypes = [P, P, P, P, P, I, I, I, Fl, I, P,
                                           P, P]
    lib.tiles_stream_dv.argtypes = [P, P, P, P, P, I, I, I, Fl, I, I, I, I,
                                    P, P, P]
    lib.tiles_stream_dv_mma.argtypes = lib.tiles_stream_apply_mma.argtypes
    for fn in (lib.tiles_stream_stats, lib.tiles_stream_apply,
               lib.tiles_stream_stats_mma, lib.tiles_stream_apply_mma,
               lib.tiles_stream_dv, lib.tiles_stream_dv_mma):
        fn.restype = I
    clk = ctypes.CDLL(paths["clocks"])
    for name in ("tiles_stream_stats", "tiles_stream_apply",
                 "tiles_stream_dv"):
        getattr(clk, name).argtypes = getattr(lib, name).argtypes
        getattr(clk, name).restype = I
    clk.tiles_phase_clocks.argtypes = [P]
    clk.tiles_phase_clocks.restype = I
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    if os.path.exists(cuobjdump):
        os.makedirs("chiprun_out", exist_ok=True)
        sass = os.path.join("chiprun_out", "streaming_tiles.sass")
        with open(sass, "w") as f:
            subprocess.run([cuobjdump, "-sass", lib_path], stdout=f,
                           stderr=subprocess.STDOUT)
        sass_summary(sass)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    stream = torch.cuda.current_stream().cuda_stream

    def close(got, want, rtol, atol_of_max):
        got, want = got.float(), want.float()
        bound = rtol * want.abs() + atol_of_max * want.abs().max()
        err = (got - want).abs()
        return (bool(torch.isfinite(got).all()) and bool((err <= bound).all()),
                err.max().item())

    def phase_line(what, run, kernel, after=None):
        """Cycles by phase of one launch of the clock build (thread 0 of
        each block, summed)."""
        sums = (ctypes.c_ulonglong * 16)()
        clk.tiles_phase_clocks(sums)
        rc = run()
        torch.cuda.synchronize()
        clk.tiles_phase_clocks(sums)
        got = list(sums)[8 * kernel:8 * kernel + 8]
        total = sum(got) or 1
        print(f"  phases of {what} (rc {rc}): " + ", ".join(
            f"{name} {100.0 * n / total:.1f} %"
            for name, n in zip(PHASES[kernel], got) if name))
        if after is not None:
            after()

    for s_len, d in SHAPES:
        q, k, v, g = ((torch.randn((BATCH, s_len, d), generator=gen,
                                   device=dev) * std).to(bf)
                      for std in (QK_STD, QK_STD, 1.0, 1.0))
        scale = d ** -0.5
        st2 = (ctypes.c_longlong * 4)(*[x for t in (q, k)
                                        for x in (t.stride(0), t.stride(1))])
        out = torch.empty_like(q)
        out32 = torch.empty(q.shape, dtype=torch.float32, device=dev)
        st4 = (ctypes.c_longlong * 8)(*[x for t in (q, k, v, out)
                                        for x in (t.stride(0), t.stride(1))])
        stdv = (ctypes.c_longlong * 8)(*[x for t in (q, k, g, out32)
                                         for x in (t.stride(0), t.stride(1))])
        stats = torch.empty((2, BATCH, s_len), dtype=torch.float32,
                            device=dev)
        m, l = stats[0], stats[1]
        for axis in ("q", "k"):
            aq = int(axis == "q")
            other = "k" if axis == "q" else "q"
            tag = f"S={s_len} D={d} {axis}"
            m_want, l_want = (t[:, 0] for t in sa.streaming_stats_reference(
                q, k, scale, axis))
            want = sa.streaming_apply_reference(
                q, k, v, m_want[:, None], l_want[:, None], scale, axis)
            wrong = sa.streaming_attention_reference(q, k, v, scale, other)
            want32 = sa.streaming_apply_reference(
                q, k, v, m_want[:, None], l_want[:, None], scale, axis,
                out_dtype=torch.float32)

            def run_stats(stages=0, no_memory=0, kept=0, lib=lib):
                return lib.tiles_stream_stats(
                    q.data_ptr(), k.data_ptr(), st2, BATCH, s_len, d, scale,
                    aq, stages, kept, no_memory, m.data_ptr(), l.data_ptr(),
                    stream)

            def run_apply(stages=0, no_memory=0, f32=0, lib=lib, ac=0):
                o = out32 if f32 else out
                return lib.tiles_stream_apply(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    st4, BATCH, s_len, d, scale, aq, f32, stages, ac,
                    no_memory, m.data_ptr(), l.data_ptr(), stream)

            def check_stats(what, rc):
                torch.cuda.synchronize()
                ok = (rc == 0 and torch.allclose(m, m_want, rtol=1e-5,
                                                 atol=1e-4)
                      and torch.allclose(l, l_want, rtol=1e-4, atol=0))
                if not ok:
                    failed.append(f"{what} {tag} rc {rc}")
                return ok

            def load_plain_stats():
                m.copy_(m_want)
                l.copy_(l_want)

            def check_apply(what, rc, f32=0):
                torch.cuda.synchronize()
                ok, err = close(out32 if f32 else out, want32 if f32 else want,
                                1e-2, 1e-2)
                if rc != 0 or not ok:
                    failed.append(f"{what} {tag} rc {rc} err {err:.3e}")
                return ok and rc == 0, err

            # The entry points' choices first: the quick check.
            stats.fill_(float("nan"))
            ok_s = check_stats("stats (default)", run_stats())
            load_plain_stats()
            out.fill_(float("nan"))
            ok_a, err_a = check_apply("apply (default)", run_apply())
            wrong_ok = not close(out, wrong, 1e-2, 1e-2)[0]
            if not wrong_ok:
                failed.append(f"wrong axis passes {tag}")
            out32.fill_(float("nan"))
            ok32, err32 = check_apply("apply fp32 out (default)",
                                      run_apply(f32=1), f32=1)
            print(f"{tag}: stats {'ok' if ok_s else 'FAILED'}; apply "
                  f"{'ok' if ok_a else 'FAILED'} (max abs err {err_a:.3e}), "
                  f"fp32 out {'ok' if ok32 else 'FAILED'} ({err32:.3e}), "
                  f"wrong axis {'fails' if wrong_ok else 'PASSES'}",
                  flush=True)

            # dV from the plain stats into out32, the roles swapped inside.
            dv_want = sa.streaming_dv_reference(
                q, k, g, m_want[:, None], l_want[:, None], scale, axis)
            mo, lo = sa.streaming_stats_reference(q, k, scale, other)
            dv_wrong = sa.streaming_dv_reference(q, k, g, mo, lo, scale,
                                                 other)
            del mo, lo

            def run_dv(stages=0, ac=0, no_memory=0, lib=lib):
                return lib.tiles_stream_dv(
                    q.data_ptr(), k.data_ptr(), g.data_ptr(),
                    out32.data_ptr(), stdv, BATCH, s_len, d, scale, aq,
                    stages, ac, no_memory, m.data_ptr(), l.data_ptr(),
                    stream)

            def run_dv_mma():
                return lib.tiles_stream_dv_mma(
                    q.data_ptr(), k.data_ptr(), g.data_ptr(),
                    out32.data_ptr(), stdv, BATCH, s_len, d, scale, aq,
                    m.data_ptr(), l.data_ptr(), stream)

            def check_dv(what, rc, got=None):
                torch.cuda.synchronize()
                ok, err = close(out32 if got is None else got, dv_want,
                                DV_RTOL, DV_OF_MAX)
                if rc != 0 or not ok:
                    failed.append(f"dV {what} {tag} rc {rc} err {err:.3e}")
                return ok and rc == 0, err

            out32.fill_(float("nan"))
            ok_dv, err_dv = check_dv("(default)", run_dv())
            dv_wrong_ok = not close(out32, dv_wrong, DV_RTOL, DV_OF_MAX)[0]
            if not dv_wrong_ok:
                failed.append(f"dV wrong axis passes {tag}")
            counts = (sa.streaming_dv.launches,
                      sa.streaming_dv.wgmma_launches)
            got = sa.streaming_dv(q, k, g, m[:, None], l[:, None], scale,
                                  axis)
            ok_w, err_w = check_dv("through streaming_dv", 0, got)
            counted = (sa.streaming_dv.launches - counts[0],
                       sa.streaming_dv.wgmma_launches - counts[1])
            if counted != (1, 1):
                failed.append(f"streaming_dv {tag}: (launches, wgmma) "
                              f"{counted}, not (1, 1)")
            del got
            out32.fill_(float("nan"))
            ok_dvm, err_dvm = check_dv("mma.sync", run_dv_mma())
            print(f"{tag}: dV {'ok' if ok_dv else 'FAILED'} (max abs err "
                  f"{err_dv:.3e}), through streaming_dv "
                  f"{'ok' if ok_w else 'FAILED'} ({err_w:.3e}, counted "
                  f"{counted}), mma.sync {'ok' if ok_dvm else 'FAILED'} "
                  f"({err_dvm:.3e}), wrong axis "
                  f"{'fails' if dv_wrong_ok else 'PASSES'}", flush=True)
            if quick:
                continue

            st_times, ap_times, nomem = {}, {}, {}
            for kept in STATS_KEPT:
                for stages in STATS_STAGES:
                    stats.fill_(float("nan"))
                    rc = run_stats(stages, 0, kept)
                    if rc == -1:
                        continue
                    check_stats(f"stats kept {kept} stages {stages}", rc)
                    st_times[(kept, stages)] = time_ms(
                        torch, lambda: run_stats(stages, 0, kept))
                if (kept, 0) in st_times:
                    nomem[f"stats, {kept} kept rows"] = time_ms(
                        torch, lambda: run_stats(0, 1, kept))
            load_plain_stats()
            for ac in APPLY_CHUNKS:
                for stages in APPLY_STAGES:
                    out.fill_(float("nan"))
                    rc = run_apply(stages, ac=ac)
                    if rc == -1:
                        continue
                    ok, _ = check_apply(f"apply {ac}-chunk loads stages "
                                        f"{stages}", rc)
                    ap_times[(ac, stages)] = (time_ms(
                        torch, lambda: run_apply(stages, ac=ac)), ok)
                if (ac, 0) in ap_times:
                    nomem[f"apply, {ac}-chunk loads"] = time_ms(
                        torch, lambda: run_apply(0, 1, ac=ac))
            load_plain_stats()
            ms_f32 = time_ms(torch, lambda: run_apply(f32=1))
            mma_stats = time_ms(torch, lambda: lib.tiles_stream_stats_mma(
                q.data_ptr(), k.data_ptr(), st2, BATCH, s_len, d, scale, aq,
                m.data_ptr(), l.data_ptr(), stream))
            load_plain_stats()
            mma_apply = time_ms(torch, lambda: lib.tiles_stream_apply_mma(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                st4, BATCH, s_len, d, scale, aq, m.data_ptr(), l.data_ptr(),
                stream))
            ok_mma, _ = check_apply("mma.sync apply", 0)
            ms_default = (time_ms(torch, run_stats),
                          ap_times.get((sa.wgmma_plan(d)[3], 0),
                                       (float("nan"),))[0])
            line = ""
            if axis == "k":
                qh, kh, vh = (t[:, None] for t in (q, k, v))
                ms_sdpa = time_ms(torch, lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, scale=scale))
                line = f"; SDPA {ms_sdpa:.4f}"
            print(f"  stats (kept rows, stages: ms): " + "  ".join(
                f"({kr}, {s_ or 'max'}): {t:.4f}"
                for (kr, s_), t in st_times.items()))
            print(f"  apply (chunks a load, stages: ms): " + "  ".join(
                f"({c}, {s_ or 'max'}): {t:.4f}{'' if ok else ' FAILED'}"
                for (c, s_), (t, ok) in ap_times.items()))
            print(f"  no memory (ms, the most stages): " + "  ".join(
                f"{what}: {t:.4f}" for what, t in nomem.items()))
            # Cycles by phase, the clock build at the entry points'
            # choices and at 128 kept rows.
            for what, run, kernel in (
                    ("stats", lambda: run_stats(lib=clk), 0),
                    ("stats, 64 kept rows",
                     lambda: run_stats(kept=64, lib=clk), 0),
                    ("apply", lambda: run_apply(lib=clk), 1)):
                phase_line(what, run, kernel, load_plain_stats)
            print(f"  entry points: stats {ms_default[0]:.4f} + apply "
                  f"{ms_default[1]:.4f} = {sum(ms_default):.4f} ms (fp32 out "
                  f"{ms_f32:.4f}); mma.sync stats "
                  f"{mma_stats:.4f} + apply "
                  f"{mma_apply:.4f}{'' if ok_mma else ' FAILED'} = "
                  f"{mma_stats + mma_apply:.4f}{line}", flush=True)

            # dV: the mma.sync kernel it replaced and the wgmma one in one
            # call, old, new, new, old; then each load size and ring depth,
            # no memory, and the phases.
            ab = [time_ms(torch, f)
                  for f in (run_dv_mma, run_dv, run_dv, run_dv_mma)]
            bound = 4.0 * BATCH * s_len * s_len * d / PEAK_BF16 * 1e3
            print(f"  dV: mma.sync {ab[0]:.4f}, wgmma {ab[1]:.4f}, wgmma "
                  f"{ab[2]:.4f}, mma.sync {ab[3]:.4f} ms (bound {bound:.4f}, "
                  f"operations; forward apply, same axis of the apply "
                  f"kernel: {'k' if axis == 'q' else 'q'})", flush=True)
            cells = []
            for ac in APPLY_CHUNKS:
                for stages in APPLY_STAGES:
                    out32.fill_(float("nan"))
                    rc = run_dv(stages, ac)
                    if rc == -1:
                        continue
                    ok, _ = check_dv(f"{ac}-chunk loads stages {stages}", rc)
                    cells.append(f"({ac}, {stages or 'max'}): "
                                 f"{time_ms(torch, lambda: run_dv(stages, ac)):.4f}"
                                 f"{'' if ok else ' FAILED'}")
            print("  dV (chunks a load, stages: ms): " + "  ".join(cells)
                  + f"; no memory {time_ms(torch, lambda: run_dv(0, 0, 1)):.4f}",
                  flush=True)
            phase_line("dV", lambda: run_dv(lib=clk), 1)
        del q, k, v, g, out, out32, stats
        torch.cuda.empty_cache()
    if failed:
        print(f"FAILED: {failed}")
        return 1
    print("every check passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
