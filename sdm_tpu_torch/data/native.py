"""ctypes binding for the native batched decoder (port of
sdm_tpu/data/native.py over the port's own csrc/sdm_decode.cc).

The C++ library decodes a whole batch of JPEG/PNG files into ONE contiguous
NHWC uint8 array with its own thread pool, in place of per-image cv2 calls,
Python-thread scheduling and the np.stack collate copy. The loader
(data/loader.py) routes batches here when (a) the library builds (g++ with
libjpeg and libpng) and (b) a canary JPEG and PNG decode BIT-IDENTICALLY to
cv2.imread, so the reference's loading contract (BGR uint8) never changes
with a differing system codec. Any failure falls back to the per-image
path, as in sdm_tpu; the fallback is logged once.

The library builds at first use into sdm_tpu_torch/csrc/build/ (git-ignored)
under a name that carries a hash of the source and the command, written to
a temporary file and renamed, so processes that build it together (test
workers, the ranks of a run) never load a half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from typing import List, Optional

import numpy as np

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
_SRC = os.path.join(_CSRC, "sdm_decode.cc")
_FLAGS = ("-O2", "-shared", "-fPIC")
_LIBS = ("-ljpeg", "-lpng", "-pthread")

_lock = threading.Lock()
_lib = None            # ctypes.CDLL once loaded
_available: Optional[bool] = None   # None: not probed yet


def library_path() -> str:
    h = hashlib.sha256(" ".join(_FLAGS + _LIBS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_CSRC, "build",
                        f"libsdm_decode-{h.hexdigest()[:12]}.so")


def _build() -> bool:
    so = library_path()
    if os.path.exists(so):
        return True
    os.makedirs(os.path.dirname(so), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(so))
    os.close(fd)
    cmd = ["g++", *_FLAGS, "-o", tmp, _SRC, *_LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        os.unlink(tmp)
        logging.info(f"native decoder build skipped: {e}")
        return False
    if proc.returncode != 0:
        os.unlink(tmp)
        logging.info(f"native decoder build failed:\n{proc.stderr[-1000:]}")
        return False
    os.replace(tmp, so)
    return True


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(library_path())
    lib.sdm_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int]
    lib.sdm_decode_batch.restype = ctypes.c_int
    lib.sdm_probe.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int]
    lib.sdm_probe.restype = ctypes.c_int
    _lib = lib
    return lib


def probe(path: str):
    """(height, width) of an image file, from its header only."""
    lib = _load()
    h = ctypes.c_int()
    w = ctypes.c_int()
    err = ctypes.create_string_buffer(512)
    if lib.sdm_probe(path.encode(), ctypes.byref(h), ctypes.byref(w),
                     err, len(err)) != 0:
        raise RuntimeError(err.value.decode(errors="replace"))
    return h.value, w.value


def decode_batch(paths: List[str], h: int, w: int,
                 num_threads: int = 0) -> np.ndarray:
    """Decode `paths` into an (N, h, w, 3) BGR uint8 array (one C call)."""
    lib = _load()
    n = len(paths)
    out = np.empty((n, h, w, 3), dtype=np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    err = ctypes.create_string_buffer(512)
    rc = lib.sdm_decode_batch(
        arr, n, h, w, out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        num_threads, err, len(err))
    if rc != 0:
        raise RuntimeError(err.value.decode(errors="replace"))
    return out


def _canary_matches_cv2() -> bool:
    """Decode one synthetic JPEG and one PNG through cv2 and the native
    library; require bit-identity."""
    import cv2

    rng = np.random.default_rng(12345)
    img = rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
    with tempfile.TemporaryDirectory() as d:
        pj = os.path.join(d, "canary.jpg")
        pp = os.path.join(d, "canary.png")
        cv2.imwrite(pj, img, [cv2.IMWRITE_JPEG_QUALITY, 90])
        cv2.imwrite(pp, img)
        ours = decode_batch([pj, pp], 24, 32)
        theirs = np.stack([cv2.imread(pj), cv2.imread(pp)])
        return bool(np.array_equal(ours, theirs))


def available() -> bool:
    """True when the native decoder is built, loadable and bit-identical
    to cv2 on the canary. Cached; safe from several threads."""
    global _available
    if _available is not None:
        return _available
    with _lock:
        if _available is not None:
            return _available
        try:
            ok = _build() and _canary_matches_cv2()
            if not ok and os.path.exists(library_path()):
                logging.info("native decoder disabled: canary decode "
                             "differs from cv2")
        except Exception as e:  # any failure: the per-image path
            logging.info(f"native decoder disabled: {e}")
            ok = False
        _available = ok
        return ok
