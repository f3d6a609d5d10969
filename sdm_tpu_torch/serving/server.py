"""DiffusionServer: HTTP front-end + micro-batching worker over SamplerEngine
(port of sdm_tpu/serving/server.py).

Stdlib-only (ThreadingHTTPServer): no framework dependency to install. All
device work happens on ONE worker thread, which enqueues on one CUDA stream
back to back, while HTTP threads only parse requests, enqueue, and wait on a
per-request event.

Micro-batching: the worker drains the queue up to the engine's max_batch
(waiting up to batch_wait_ms for stragglers once a first request is in hand)
and runs ONE padded trajectory chain for all of them. K concurrent 1-image
requests therefore cost ~one batch of device time instead of K trajectories
— the diffusion analogue of continuous batching (requests are whole
trajectories, so coalescing happens at trajectory granularity).

API (JSON):
  GET  /healthz             {"status": "ok", ...model info}
  GET  /stats               engine + server counters
  POST /generate            {"num_images": 1..max_batch, "seed": int,
                             "labels": [cond_dim floats] (conditional
                             bundles), "guidance_scale": float,
                             "format": "npy" | "png",
                             SR bundles: "lr_image_b64" (raw float32 in
                             [-1, 1], BGR) + "lr_shape" [H, W, C], or
                             "lr_image_png_b64" (an encoded PNG/JPEG; needs
                             OpenCV, imported only for it)}
    -> format "npy": {"shape": [...], "dtype": "float32",
                      "data_b64": <base64 raw array>}  (BGR, [-1,1] — the
                      framework's native space)
    -> format "png": {"images_b64": [<base64 PNG>, ...]}  (8-bit, BGR
                      denormalized exactly like the plot writer's
                      value_range=(-1,1) mapping; needs OpenCV, imported
                      only for this format)
"""

from __future__ import annotations

import base64
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from sdm_tpu_torch.serving.engine import SamplerEngine


class _Request:
    def __init__(self, payload: dict):
        self.payload = payload
        self.done = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[str] = None


def _png_bytes(img: np.ndarray) -> bytes:
    import cv2
    if img.dtype == np.uint8:  # engine output_dtype="uint8": pre-quantized
        u8 = img
    else:
        u8 = np.clip((img.astype(np.float32) + 1.0) * 127.5,
                     0, 255).astype(np.uint8)
    ok, buf = cv2.imencode(".png", u8)
    if not ok:
        raise RuntimeError("cv2.imencode failed")
    return bytes(buf)


class DiffusionServer:
    """Owns the engine, the request queue, and the device worker thread."""

    def __init__(self, engine: SamplerEngine, *, host: str = "127.0.0.1",
                 port: int = 0, batch_wait_ms: float = 20.0, log=print):
        self.engine = engine
        self.batch_wait_ms = batch_wait_ms
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._stop = threading.Event()
        self._log = log
        self.requests_served = 0
        self.requests_failed = 0
        self._count_lock = threading.Lock()

        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # route to our logger
                server._log("http: " + fmt % args)

            def _json(self, code: int, obj: dict):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    h, w, c = server.engine.img_shape
                    self._json(200, {
                        "status": "ok", "img_shape": [h, w, c],
                        "cond_dim": server.engine.cond_dim,
                        "kind": server.engine.kind,
                        "diff_alg": server.engine.diff_alg,
                        "max_batch": server.engine.max_batch})
                elif self.path == "/stats":
                    stats = server.engine.stats.snapshot()
                    stats.update(requests_served=server.requests_served,
                                 requests_failed=server.requests_failed,
                                 queue_depth=server._queue.qsize())
                    self._json(200, stats)
                else:
                    self._json(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                if self.path != "/generate":
                    self._json(404, {"error": f"no route {self.path}"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(length) or b"{}")
                    req = server._validate(payload)
                except (ValueError, json.JSONDecodeError) as e:
                    server._count("requests_failed")
                    self._json(400, {"error": str(e)})
                    return
                server._queue.put(req)
                req.done.wait()
                if req.error is not None:
                    server._count("requests_failed")
                    self._json(500, {"error": req.error})
                    return
                server._count("requests_served")
                fmt = payload.get("format", "npy")
                if fmt == "png":
                    imgs = [base64.b64encode(_png_bytes(im)).decode()
                            for im in req.result]
                    self._json(200, {"images_b64": imgs})
                else:
                    arr = np.ascontiguousarray(req.result, np.float32)
                    self._json(200, {
                        "shape": list(arr.shape), "dtype": "float32",
                        "data_b64": base64.b64encode(arr.tobytes()).decode()})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._worker = threading.Thread(target=self._worker_loop, daemon=True)
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)

    # ----------------------------------------------------------- lifecycle

    def start(self, precompile: bool = True):
        if precompile:
            self.engine.precompile()
        self._worker.start()
        self._http_thread.start()
        self._log(f"serving on http://{self.host}:{self.port} "
                  f"(max_batch={self.engine.max_batch}, "
                  f"wait={self.batch_wait_ms}ms)")

    def stop(self, timeout: float = 600.0):
        """Stop serving; waits up to `timeout` s for the batch in flight."""
        self._stop.set()
        self._queue.put(None)  # wake the worker
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._worker.is_alive():
            self._worker.join(timeout)

    def _count(self, name: str):
        with self._count_lock:
            setattr(self, name, getattr(self, name) + 1)

    # ------------------------------------------------------------- batching

    def _validate(self, payload: dict) -> _Request:
        n = payload.get("num_images", 1)
        if not isinstance(n, int) or not 1 <= n <= self.engine.max_batch:
            raise ValueError(
                f"num_images must be 1..{self.engine.max_batch}")
        if self.engine.cond_dim is not None:
            lab = payload.get("labels")
            if (not isinstance(lab, list)
                    or len(lab) != self.engine.cond_dim):
                raise ValueError(
                    f"this bundle needs 'labels' with "
                    f"{self.engine.cond_dim} floats")
        gs = float(payload.get("guidance_scale", 1.0))
        if gs != 1.0 and not self.engine.guidance:
            raise ValueError("server started without --guidance")
        if payload.get("format", "npy") not in ("npy", "png"):
            raise ValueError("format must be npy or png")
        lr_image = None
        if self.engine.kind == "sr":
            # Checked here, before queueing, so a bad image is refused with
            # 400 instead of failing the batch it would coalesce into.
            lr_image = self.engine.check_lr_image(self._decode_lr(payload))
        return _Request(dict(num_images=n, seed=int(payload.get("seed", 0)),
                             labels=payload.get("labels"),
                             guidance_scale=gs, lr_image=lr_image))

    def _decode_lr(self, payload: dict) -> np.ndarray:
        """SR input image from the request (sdm_tpu server.py:194-218):
        encoded PNG/JPEG bytes, or raw float32 [-1, 1] with an explicit
        shape. BGR, the framework's native channel order."""
        if "lr_image_png_b64" in payload:
            import cv2
            buf = base64.b64decode(payload["lr_image_png_b64"])
            img = cv2.imdecode(np.frombuffer(buf, np.uint8),
                               cv2.IMREAD_COLOR)
            if img is None:
                raise ValueError("could not decode lr_image_png_b64")
            return (img.astype(np.float32) - 127.5) / 127.5
        if "lr_image_b64" in payload:
            shape = payload.get("lr_shape")
            if (not isinstance(shape, list) or len(shape) != 3
                    or not all(isinstance(d, int) and d > 0 for d in shape)):
                raise ValueError("lr_image_b64 needs lr_shape [H, W, C]")
            raw = base64.b64decode(payload["lr_image_b64"])
            arr = np.frombuffer(raw, np.float32)
            if arr.size != int(np.prod(shape)):
                raise ValueError(
                    f"lr_image_b64 has {arr.size} floats, lr_shape wants "
                    f"{int(np.prod(shape))}")
            return arr.reshape(shape)
        raise ValueError("SR bundle requests need lr_image_png_b64 or "
                         "lr_image_b64 + lr_shape")

    def _drain_batch(self, block: bool = True) -> list:
        """Coalesce compatible queued requests up to max_batch, waiting
        batch_wait_ms for stragglers. block=False returns [] immediately
        when the queue is idle (the worker uses it while a dispatched batch
        is still in flight — see _worker_loop)."""
        try:
            first = self._queue.get(block=block)
        except queue.Empty:
            return []
        if first is None or self._stop.is_set():
            return []
        batch, total = [first], first.payload["num_images"]
        deadline = time.monotonic() + self.batch_wait_ms / 1000.0
        gs = first.payload["guidance_scale"]
        while total < self.engine.max_batch:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                nxt = self._queue.get(timeout=timeout)
            except queue.Empty:
                break
            if nxt is None:
                break
            if (nxt.payload["guidance_scale"] != gs
                    or total + nxt.payload["num_images"]
                    > self.engine.max_batch):
                # Incompatible or overflowing: hand it back for the next
                # batch (order within the queue may shift; acceptable).
                self._queue.put(nxt)
                break
            batch.append(nxt)
            total += nxt.payload["num_images"]
        return batch

    def _worker_loop(self):
        # One dispatched batch stays in flight: the NEXT batch's device work
        # is enqueued before the previous batch's host fetch (finalize), so
        # under sustained load the result copy rides under device compute.
        # With an idle queue this degenerates to dispatch -> finalize.
        inflight = None  # (batch, handle)

        def _finalize(batch, handle):
            try:
                results = self.engine.finalize(handle)
                for r, out in zip(batch, results):
                    r.result = out
            except Exception as e:
                for r in batch:
                    r.error = f"{type(e).__name__}: {e}"
            finally:
                for r in batch:
                    r.done.set()

        while not self._stop.is_set():
            batch = self._drain_batch(block=inflight is None)
            if batch:
                try:
                    handle = self.engine.dispatch([r.payload for r in batch])
                except Exception as e:  # surface to every waiter
                    for r in batch:
                        r.error = f"{type(e).__name__}: {e}"
                        r.done.set()
                    batch = None
                    handle = None
            else:
                batch = None
                handle = None
            if inflight is not None:
                _finalize(*inflight)
            inflight = (batch, handle) if batch is not None else None
        if inflight is not None:
            _finalize(*inflight)
