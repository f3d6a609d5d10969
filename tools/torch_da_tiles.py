#!/usr/bin/env python3
"""Sweep of the streaming backward's dK and dQ kernel, `stream_da_wgmma`
(csrc/streaming_attention.cu), on one NVIDIA GPU.

    python3 tools/torch_da_tiles.py [--quick]

Builds tools/torch_da_tiles.cu (the library's source with the ring depth
left open, and `stream_da_mma`, the mma.sync kernel it replaced) once a
setting of the library's compile-time tiling, all builds at once: the
defaults (64-row streamed tiles, loads of four 64-column chunks where they
divide D's, else two), loads of two chunks (-DDA_LOAD_CHUNKS=2), 32-row
tiles with m64n16 score products (-DDA_TILE=32: the n16 tiling of the
old kernel kept on wgmma, the control) and the defaults with phase clocks
(-DSW_PHASE_CLOCKS). Prints ptxas's registers and spills of each
instantiation and any line on serialized wgmma (a spill or a serialized
wgmma fails the run), and where cuobjdump is found each kernel's HGMMA
count and full waits (chiprun_out/da_tiles.sass). Then, at (16, 1024,
512) bf16 on both softmax axes, every setting, the old kernel and the
wrappers `streaming_dk` / `streaming_dq` against the plain dK and dQ:
chip_smoke.py's BWD_TOL on the key axis and its float64 truth (BWD_TRUTH)
on the query axis, and two runs of each to the same bits. At the SR
model's (16, 4096, 512): the old and the new kernel old, new, new, old
(CUDA events over back-to-back launches), every setting at each ring
depth, the wrappers, and the default's cycles by phase (the clock build:
thread 0 of every block, summed), beside the operations bound. `--quick`
builds the defaults and runs the checks alone (a new kernel's first
call). Every check runs before the script fails. Exits 2 without a CUDA
device, 1 on any failed check.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
import threading

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

BATCH = 16
QK_STD = 1.5
CHECK_SHAPE, TIME_SHAPE = (1024, 512), (4096, 512)
# chip_smoke.py BWD_TOL["bfloat16"] (|got - plain| <= rtol |plain| +
# of_max max|plain|) and BWD_TRUTH (query axis: the error against a float64
# truth at most mult x the plain version's + add, on TRUTH_ROWS rows).
RTOL = OF_MAX = 2e-2
TRUTH_MULT, TRUTH_ADD, TRUTH_ROWS = 2.0, 1e-3, 2
PEAK_BF16 = 989e12   # H100 SXM dense bf16 FLOP/s
SETTINGS = {"default": (), "chunks2": ("-DDA_LOAD_CHUNKS=2",),
            "tile32": ("-DDA_TILE=32",), "clocks": ("-DSW_PHASE_CLOCKS",)}
STAGES = (0, 2, 3, 4)   # 0: the most that fit
PHASES = ("scores full wait", "scores issue + retire", "",
          "dA on the fragments", "named barrier", "dA B full wait",
          "dA B issue + retire", "")


def build(_build, names):
    """One nvcc a setting, all at once; returns ({name: path}, failures)."""
    src = os.path.join(HERE, "torch_da_tiles.cu")
    paths = {n: os.path.join(_build.BUILD_DIR, f"libtorch_da_tiles_{n}.so")
             for n in names}
    jobs = {n: subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, *SETTINGS[n], "-o", paths[n],
         src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for n in names}
    outs = {n: j.communicate()[0] for n, j in jobs.items()}
    failed = []
    for n, out in outs.items():
        if jobs[n].returncode != 0:
            print(out, file=sys.stderr)
            failed.append(f"build {n}")
            continue
        fn = None
        for line in out.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?(\w+)", line)
            if m:
                fn = m.group(1)
            elif fn and "stream_da_" in fn and ("registers" in line
                                               or "spill" in line):
                print(f"ptxas {n}: {demangle(fn)}: {line.strip()}")
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill",
                              line)
                if m and (int(m.group(1)) or int(m.group(2))):
                    failed.append(f"{n}: {demangle(fn)} spills")
            if "serializ" in line and "wgmma" in line:
                print(f"ptxas {n}: {line.strip()}")
                failed.append(f"{n}: serialized wgmma")
    return paths, failed


def demangle(name):
    try:
        out = subprocess.run(["c++filt", name], capture_output=True,
                             text=True, timeout=30).stdout.strip()
        return re.sub(r"\(.*", "", out) or name
    except OSError:
        return name


def sass_summary(path, part):
    """Per kernel of the SASS whose name holds `part`: its HGMMA count and
    its full waits (WARPGROUP.DEPBAR.LE gsb0, 0x0); where ptxas serialized
    the wgmma pipeline there is one such wait after every HGMMA."""
    counts, name = {}, None
    with open(path) as f:
        for line in f:
            m = re.search(r"Function : (\S+)", line)
            if m:
                name = m.group(1) if part in m.group(1) else None
                if name:
                    counts[name] = [0, 0]
            elif name and "HGMMA" in line:
                counts[name][0] += 1
            elif name and "DEPBAR.LE gsb0, 0x0" in line:
                counts[name][1] += 1
    for name, (hgmma, waits) in counts.items():
        print(f"sass: {demangle(name)}: {hgmma} HGMMA, {waits} full waits")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_da_tiles: no CUDA device", file=sys.stderr)
        return 2
    from torch_attention_tiles import time_ms
    from sdm_tpu_torch.kernels import _build
    from sdm_tpu_torch.kernels import streaming_attention as sa
    quick = sys.argv[1:] == ["--quick"]
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    names = ["default"] if quick else list(SETTINGS)
    # The port's own library (the wrappers and the forward passes that
    # make the stats) builds beside the settings.
    port = threading.Thread(target=_build.build,
                            args=(["streaming_attention"],))
    port.start()
    paths, failed = build(_build, names)
    port.join()
    # A setting that does not build is reported and left out.
    names = [n for n in names if f"build {n}" not in failed]
    if "default" not in names:
        print(f"FAILED: {failed}")
        return 1
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    if os.path.exists(cuobjdump):
        os.makedirs("chiprun_out", exist_ok=True)
        sass = os.path.join("chiprun_out", "da_tiles.sass")
        with open(sass, "w") as f:
            subprocess.run([cuobjdump, "-sass", paths["default"]], stdout=f,
                           stderr=subprocess.STDOUT)
        sass_summary(sass, "stream_da_")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs = {}
    for n in names:
        lib = ctypes.CDLL(paths[n])
        lib.tiles_da_wgmma.argtypes = [I, P, P, P, P, P, P, I, I, I, F, I, I,
                                       P, P, P, P]
        lib.tiles_da_mma.argtypes = [I, P, P, P, P, P, P, I, I, I, F, I, P,
                                     P, P, P]
        lib.tiles_da_setting.argtypes = [I, P]
        for fn in (lib.tiles_da_wgmma, lib.tiles_da_mma,
                   lib.tiles_da_setting):
            fn.restype = I
        libs[n] = lib
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    four = (ctypes.c_int * 4)()
    for n, lib in libs.items():
        lib.tiles_da_setting(512, four)
        print(f"setting {n}: DA_TILE {four[0]}, at D = 512 loads of {four[1]} chunks, "
              f"{four[2]} stages, {four[3]} bytes")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream

    def inputs(s_len, d):
        return [(torch.randn((BATCH, s_len, d), generator=gen, device=dev)
                 * std).to(torch.bfloat16)
                for std in (QK_STD, QK_STD, 1.0, 1.0)]

    def backward_inputs(q, k, v, g, scale, axis):
        m, l = sa.streaming_stats(q, k, scale, axis)
        out32 = sa.streaming_apply(q, k, v, m, l, scale, axis,
                                   out_dtype=torch.float32)
        dv = sa.streaming_dv(q, k, g, m, l, scale, axis)
        corr = sa.streaming_correction(g, v, out32, dv, axis).contiguous()
        return m, l, corr

    def runner(q, k, v, g, m, l, corr, scale, axis, pname, out):
        """Launchers of one pass into `out`: (lib, stages) -> the new
        kernel, (lib, None) -> the old one; the roles of sdm_streaming_dq /
        sdm_streaming_dk."""
        ops = (q, g, k, v) if pname == "dq" else (k, v, q, g)
        stat_col = int((axis == "q") == (pname == "dq"))
        st = (ctypes.c_longlong * 10)(*[x for t in (*ops, out)
                                        for x in (t.stride(0), t.stride(1))])
        s_len, d = q.shape[1], q.shape[2]

        def run(lib, stages):
            args = [int(pname == "dq"), *(t.data_ptr() for t in ops),
                    out.data_ptr(), ctypes.cast(st, P), BATCH, s_len, d,
                    scale, stat_col]
            tail = [m.data_ptr(), l.data_ptr(), corr.data_ptr(), stream]
            if stages is None:
                return lib.tiles_da_mma(*args, *tail)
            return lib.tiles_da_wgmma(*args, stages, *tail)
        return run

    # ------------------------------------------------------------ checks
    s_len, d = CHECK_SHAPE
    q, k, v, g = inputs(s_len, d)
    scale = d ** -0.5
    for axis in ("q", "k"):
        m, l, corr = backward_inputs(q, k, v, g, scale, axis)
        truth = None
        if axis == "q":
            grads = [[], []]
            for b in range(TRUTH_ROWS):
                qb, kb, vb = (t[b].double().requires_grad_()
                              for t in (q, k, v))
                p = torch.softmax(qb @ kb.T * scale, dim=0)
                for acc, gr in zip(grads, torch.autograd.grad(
                        p @ vb, (qb, kb), g[b].double())):
                    acc.append(gr)
            truth = {"dq": torch.stack(grads[0]),
                     "dk": torch.stack(grads[1])}
        for pname in ("dq", "dk"):
            out = torch.empty((BATCH, s_len, d), dtype=torch.float32,
                              device=dev)
            run = runner(q, k, v, g, m, l, corr, scale, axis, pname, out)
            plain = (sa.streaming_dq_reference if pname == "dq"
                     else sa.streaming_dk_reference)(q, k, v, g, m, l, corr,
                                                     scale, axis)
            wrapper = sa.streaming_dq if pname == "dq" else sa.streaming_dk
            tag = f"{pname} S={s_len} D={d} {axis}"
            cases = [(f"{n}", lambda lib=lib: run(lib, 0))
                     for n, lib in libs.items()]
            def through_wrapper():
                out.copy_(wrapper(q, k, v, g, m, l, corr, scale, axis))
                return 0
            cases += [("old stream_da_mma",
                       lambda: run(libs["default"], None)),
                      ("wrapper", through_wrapper)]
            for what, call in cases:
                got = []
                for _ in range(2):
                    out.fill_(float("nan"))
                    rc = call()
                    torch.cuda.synchronize()
                    got.append(out.clone())
                if rc == -1:
                    print(f"check {tag} {what}: refused (the shape or the "
                          "ring does not fit)")
                    continue
                ok = rc == 0 and bool(torch.isfinite(got[0]).all())
                same = torch.equal(got[0], got[1])
                if truth is None:
                    err = (got[0] - plain).abs()
                    ok = ok and bool((err <= RTOL * plain.abs() + OF_MAX
                                      * plain.abs().max()).all())
                    note = f"max abs err {err.max().item():.3e}"
                else:
                    rows = list(range(TRUTH_ROWS))

                    def e(x):
                        t = truth[pname]
                        return ((x[rows].double() - t).abs().max()
                                / t.abs().max()).item()
                    e_k, e_p = e(got[0]), e(plain)
                    ok = ok and e_k <= TRUTH_MULT * e_p + TRUTH_ADD
                    note = (f"vs float64 truth {e_k:.3e} (plain {e_p:.3e}, "
                            f"limit {TRUTH_MULT * e_p + TRUTH_ADD:.3e})")
                if not ok or not same:
                    failed.append(f"{what} {tag} rc {rc} {note} "
                                  f"{'same bits' if same else 'BITS DIFFER'}")
                print(f"check {tag} {what}: {'ok' if ok else 'FAILED'}, "
                      f"{note}, {'same bits twice' if same else 'BITS DIFFER'}",
                      flush=True)
        del m, l, corr
    del q, k, v, g
    torch.cuda.empty_cache()
    if quick:
        print(f"FAILED: {failed}" if failed else "every check passed")
        return 1 if failed else 0

    # ------------------------------------------------------------ timing
    s_len, d = TIME_SHAPE
    q, k, v, g = inputs(s_len, d)
    scale = d ** -0.5
    bound = 6.0 * BATCH * s_len * s_len * d / PEAK_BF16 * 1e3
    clk = libs.get("clocks")
    if clk is not None:
        clk.tiles_da_phase_clocks.argtypes = [P]
        clk.tiles_da_phase_clocks.restype = I
    for axis in ("q", "k"):
        m, l, corr = backward_inputs(q, k, v, g, scale, axis)
        for pname in ("dk", "dq"):
            out = torch.empty((BATCH, s_len, d), dtype=torch.float32,
                              device=dev)
            run = runner(q, k, v, g, m, l, corr, scale, axis, pname, out)
            tag = f"{pname} S={s_len} D={d} {axis}"
            old = lambda: run(libs["default"], None)
            new = lambda: run(libs["default"], 0)
            ab = [time_ms(torch, f) for f in (old, new, new, old)]
            print(f"{tag}: old {ab[0]:.4f}, new {ab[1]:.4f}, new "
                  f"{ab[2]:.4f}, old {ab[3]:.4f} ms (bound {bound:.4f}, "
                  f"operations)", flush=True)
            cells = []
            for n, lib in libs.items():
                if n == "clocks":
                    continue
                for stages in STAGES:
                    if run(lib, stages) != 0:
                        continue
                    cells.append(f"{n}/{stages or 'max'} "
                                 f"{time_ms(torch, lambda: run(lib, stages)):.4f}")
            wrapper = sa.streaming_dq if pname == "dq" else sa.streaming_dk
            ms_w = time_ms(torch, lambda: wrapper(q, k, v, g, m, l, corr,
                                                  scale, axis))
            print("  settings/stages ms: " + "  ".join(cells)
                  + f"; wrapper {ms_w:.4f}", flush=True)
            if clk is not None:
                sums = (ctypes.c_ulonglong * 8)()
                clk.tiles_da_phase_clocks(sums)
                rc = run(clk, 0)
                torch.cuda.synchronize()
                clk.tiles_da_phase_clocks(sums)
                total = sum(sums) or 1
                print(f"  phases (rc {rc}): " + ", ".join(
                    f"{name} {100.0 * n / total:.1f} %"
                    for name, n in zip(PHASES, sums) if name), flush=True)
        del m, l, corr
    if failed:
        print(f"FAILED: {failed}")
        return 1
    print("every check passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
