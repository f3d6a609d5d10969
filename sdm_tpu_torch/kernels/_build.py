"""Builds and loads the port's CUDA kernels.

Each source `sdm_tpu_torch/csrc/<name>.cu` compiles with nvcc into a shared
library with a plain C interface, `csrc/build/lib<name>-<hash>.so`, loaded
with ctypes. The hash covers the source, every header of csrc/ and the
flags, so an edited kernel rebuilds and a stale library is never loaded. Nothing is built at import:
the first launch builds what it needs, and `build()` compiles every missing
library at once (one nvcc process per source, all started together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Tuple

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
SOURCES = ("adagn", "attention", "attention_block", "linear",
           "streaming_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on "
                           "PATH or set CUDA_HOME")
    return path


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for src in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, src), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build_log(name: str) -> str:
    """nvcc's output for the current build of `name` (ptxas register and
    shared-memory report included)."""
    with open(library_path(name)[:-3] + ".log") as f:
        return f.read()


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every library of `names` that is missing, all nvcc processes
    at once. Returns {name: library path}; raises with nvcc's output on a
    failed build."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = []
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        log = open(out[:-3] + ".log", "w")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        jobs.append((name, subprocess.Popen(cmd, stdout=log,
                                            stderr=subprocess.STDOUT),
                     tmp, out, log))
    failed = []
    for name, proc, tmp, out, log in jobs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"nvcc failed for {name}.cu (exit {rc}):\n"
                          + build_log(name))
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: library_path(name) for name in names}


def library(name: str, signatures: Dict[str, Tuple[type, list]]
            ) -> ctypes.CDLL:
    """The loaded library `name` (built first if missing), with restype and
    argtypes declared from `signatures` = {symbol: (restype, argtypes)}."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not os.path.exists(path):
                build([name])
            lib = ctypes.CDLL(path)
            lib.sdm_error_string.restype = ctypes.c_char_p
            lib.sdm_error_string.argtypes = [ctypes.c_int]
            for symbol, (restype, argtypes) in signatures.items():
                fn = getattr(lib, symbol)
                fn.restype = restype
                fn.argtypes = argtypes
            _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({lib.sdm_error_string(rc).decode()})")


def dtype_code(t: torch.Tensor, what: str) -> int:
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"{what}: dtype {t.dtype} not supported "
                        "(float32 or bfloat16)")
    return code


def on_device(device: torch.device):
    """The context every ctypes launch runs in: `device` (the card that
    owns the tensors and the stream) made current, so the C entry point's
    cudaFuncSetAttribute and kernel launch act on that card, whichever is
    current around the call (a replica or pipeline stage on cuda:1)."""
    return torch.cuda.device(device)


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(what: str, *tensors: torch.Tensor) -> None:
    """Every tensor on one CUDA device, or raise."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{what}: tensors on {dev}; the kernel runs on CUDA "
                         "(CPU tensors take the plain version)")
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {dev} and {t.device}")
