#!/usr/bin/env python3
"""Sweep of the port's attention block (`fused_attention_block`, one C call
a block: csrc/attention_block.cu) on one NVIDIA GPU.

    python3 tools/torch_block_tiles.py

Builds the port's libraries and tools/torch_block_tiles.cu (the block's
source with -DBFUSED_MIN_S=256, so that (256, 512) takes the fused route)
with the port's nvcc flags, and prints the fused apply's registers, spills
and any ptxas line on serialized wgmma. Then at every whole-S block shape
of the flagship 128x128 and the SR 256x256 U-Net (batch 16, bf16, d_k = C),
both softmax axes:

- the route the library takes (`block_route`) and its output against
  `attention_block_reference` (1e-2 of the element plus 1e-2 of the largest
  output, chip_smoke.py's ATTN_TOL);
- the three-wrapper route this design replaced (`linear`, `fused_attention`
  on views of the qkv buffer, `linear` with the residual: four ctypes calls
  and four launches a block, kept here only) against the one C call, old,
  new, new, old, each back to back and queued behind a sleep kernel (the
  device time alone), CUDA events, 10 launches each;
- at (256, 512), the library's four launches (the apply at split 2)
  against the fused route of the -DBFUSED_MIN_S=256 build, split, fused,
  fused, split, the same two ways.

Sums per flagship call (its four blocks) and per SR call (its three
whole-S blocks) follow; everything also goes to
chiprun_out/block_tiles.json. Exits 2 without a CUDA device, 1 on any
failed check.
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

FLAGSHIP = [(1024, 512), (256, 512), (64, 1024), (256, 1024)]
SR = [(1024, 512), (256, 1024), (1024, 1024)]
BATCH = 16
QK_STD = 1.5
REPS = 10
FUSED_MIN_S = 256     # the tool build's -DBFUSED_MIN_S


def time_ms(torch, fn, queued):
    """Mean ms of fn over REPS launches (CUDA events), warmed up; queued:
    behind a sleep kernel, so the host's time per call drops out."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def old_block(tokens, w_qkv, b_qkv, w_out, b_out, scale, axis):
    """The three-wrapper route the one C call replaced: `linear` for qkv,
    `fused_attention` on views of the qkv buffer into r, `linear` again
    with the bias and the residual."""
    from sdm_tpu_torch.kernels.attention import fused_attention
    from sdm_tpu_torch.kernels.attention_block import linear
    n, s, c = tokens.shape
    d_k = w_out.shape[1]
    tok2 = tokens.view(n * s, c)
    qkv = linear(tok2, w_qkv, b_qkv).view(n, s, 1, 3 * d_k)
    q, k, v = qkv.split(d_k, dim=-1)
    r = fused_attention(q, k, v, scale, axis)
    return linear(r.reshape(n * s, d_k), w_out, b_out,
                  residual=tok2).view(n, s, c)


def tool_block(torch, lib, tokens, w_qkv, b_qkv, w_out, b_out, scale, axis):
    """The block through the tool build's sdm_attention_block_forward, as
    kernels/attention_block.py::_launch_block calls the library's; returns
    (out, route)."""
    from sdm_tpu_torch.kernels import _build
    from sdm_tpu_torch.kernels.attention_block import block_scratch_elems
    n, s, c = tokens.shape
    d_k = w_out.shape[1]
    out = torch.empty_like(tokens)
    route = lib.sdm_attention_block_route(
        tokens.data_ptr(), w_qkv.data_ptr(), w_out.data_ptr(),
        out.data_ptr(), 0, n, s, c, d_k, 1)
    scratch = torch.empty(block_scratch_elems(n, s, d_k, route),
                          dtype=tokens.dtype, device=tokens.device)
    stats = torch.empty(2 * n * s, dtype=torch.float32,
                        device=tokens.device)
    rc = lib.sdm_attention_block_forward(
        tokens.data_ptr(), w_qkv.data_ptr(), b_qkv.data_ptr(),
        _build.dtype_code(b_qkv, "tool"), w_out.data_ptr(), b_out.data_ptr(),
        _build.dtype_code(b_out, "tool"), out.data_ptr(), scratch.data_ptr(),
        scratch.numel(), stats.data_ptr(), n, s, c, d_k, float(scale),
        int(axis == "q"), 1, _build.stream_handle(tokens.device))
    if rc != 0:
        raise RuntimeError(f"tool block: rc {rc}")
    return out, route


def ptxas_lines(text):
    """The fused apply's register and spill lines and every line on
    serialized wgmma, from nvcc's -Xptxas -v output."""
    out, name = [], None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            name = m.group(1)
        elif name and "attn_apply_wgmma" in name and (
                "registers" in line or "spill" in line):
            out.append(f"ptxas: {name}: {line.strip()}")
        if "serializ" in line:
            out.append(f"ptxas: {line.strip()}")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_block_tiles: no CUDA device", file=sys.stderr)
        return 2
    from sdm_tpu_torch.kernels import _build
    from sdm_tpu_torch.kernels import attention_block as ab
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(_build.BUILD_DIR, "libtorch_block_tiles.so")
    tool = subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, f"-DBFUSED_MIN_S={FUSED_MIN_S}",
         "-o", lib_path, os.path.join(HERE, "torch_block_tiles.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _build.build()
    log = tool.communicate()[0]
    if tool.returncode != 0:
        print(log, file=sys.stderr)
        return 1
    failed = []
    for line in ptxas_lines(log):
        print(line)
        if "serializ" in line or re.search(r"[1-9]\d* bytes spill", line):
            failed.append(line)
    lib = ctypes.CDLL(lib_path)
    for sym, (restype, argtypes) in ab._BLOCK_SIGNATURES.items():
        getattr(lib, sym).restype = restype
        getattr(lib, sym).argtypes = argtypes
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def randn(shape, std):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(bf)

    def check(what, got, want):
        err = (got.float() - want.float()).abs()
        bound = 1e-2 * want.float().abs() + 1e-2 * want.float().abs().max()
        if not (bool(torch.isfinite(got.float()).all())
                and bool((err <= bound).all())):
            failed.append(what)
            return f"FAILED (max abs err {err.max().item():.3e})"
        return f"ok (max abs err {err.max().item():.3e})"

    rows = []
    for s_len, c in sorted(set(FLAGSHIP + SR)):
        bnd = c ** -0.5
        tok = randn((BATCH, s_len, c), QK_STD)
        w_qkv, w_out = randn((3 * c, c), bnd), randn((c, c), bnd)
        b_qkv, b_out = randn((3 * c,), bnd), randn((c,), bnd)
        for axis in ("q", "k"):
            args = (tok, w_qkv, b_qkv, w_out, b_out, c ** -0.5, axis)
            tag = f"S={s_len} C={c} {axis}"
            route = ab.block_route(bf, BATCH, s_len, c, c,
                                   (tok.data_ptr(), w_qkv.data_ptr(),
                                    w_out.data_ptr(), 0, 0))
            want = ab.attention_block_reference(*args)
            new = lambda: ab.fused_attention_block(*args)
            old = lambda: old_block(*args)
            status = (f"new {check(f'new {tag}', new(), want)}, old "
                      f"{check(f'old {tag}', old(), want)}")
            row = dict(s=s_len, c=c, axis=axis, route=route,
                       models=[m for m, sh in (("flagship", FLAGSHIP),
                                               ("sr", SR))
                               if (s_len, c) in sh])
            for mode in ("back_to_back", "queued"):
                q = mode == "queued"
                row[mode] = {"old": [time_ms(torch, old, q)],
                             "new": [time_ms(torch, new, q)]}
                row[mode]["new"].append(time_ms(torch, new, q))
                row[mode]["old"].append(time_ms(torch, old, q))
            if (s_len, c) == (256, 512):
                fused = lambda: tool_block(torch, lib, *args)
                got, froute = fused()
                status += (f", fused (route {froute}) "
                           f"{check(f'fused {tag}', got, want)}")
                if froute != 2:
                    failed.append(f"tool build route {froute} at {tag}")
                for mode in ("back_to_back", "queued"):
                    q = mode == "queued"
                    row[mode]["split"] = [time_ms(torch, new, q)]
                    row[mode]["fused"] = [time_ms(torch, fused, q),
                                          time_ms(torch, fused, q)]
                    row[mode]["split"].append(time_ms(torch, new, q))
            rows.append(row)
            print(f"{tag} route {route}: {status}")
            for mode in ("back_to_back", "queued"):
                print(f"  {mode:12s} " + "  ".join(
                    f"{k} " + ", ".join(f"{x:.4f}" for x in v)
                    for k, v in row[mode].items()), flush=True)

    sums = {}
    for model, shapes in (("flagship", FLAGSHIP), ("sr", SR)):
        for axis in ("q", "k"):
            for mode in ("back_to_back", "queued"):
                for route in ("old", "new"):
                    sums[f"{model} {axis} {mode} {route}"] = sum(
                        sum(r[mode][route]) / len(r[mode][route])
                        for r in rows if r["axis"] == axis
                        and (r["s"], r["c"]) in shapes)
    for key, ms in sums.items():
        print(f"per {key}: {ms:.4f} ms")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "block_tiles.json"), "w") as f:
        json.dump(dict(card=card, torch=torch.__version__, rows=rows,
                       sums=sums, failed=failed), f, indent=1)
    for what in failed:
        print(f"FAILED: {what}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
