"""SamplerEngine: keep-resident sampling over a bundle (port of
sdm_tpu/serving/engine.py).

Bundle parsing, checkpoint loading and the upload to the device happen once
at construction. Requests of any size <= max_batch are zero-padded to that
batch and sliced after.

Bundle kinds (detected from the bundle entries, as sdm_tpu does):
  eps   BASE bundles, diff_alg ddim/ddpm/dpmpp/heun: x_t chains model to
        model; v-bundles ("objective": "V") are sampled natively. With
        guidance=True (label-conditional bundles) each call runs the
        conditional and the zero-label rows as one doubled batch and
        extrapolates by the batch's guidance_scale.
  cold  BASE-COLD bundles (diff_alg="cold"): the initial noise is shared by
        the trajectory; ensemble chaining re-degrades the previous x0 to
        the next model's max_noise with it.
  sr    SR bundles (entries carry "cond_t"): each request brings a
        low-resolution image, which is area-upsampled to the model's size;
        the conditioning channels are the upsampled image q-sampled at the
        first entry's cond_t with the shared noise, built once; the cold
        delta chain runs as for "cold"; the output is upsampled + delta.

A request's noise is a function of its own seed and image count only, so
DDIM (eta = 0), cold and SR outputs are identical alone or coalesced.
DDPM's per-step z comes from a batch generator seeded by the first request:
reproducible only for an identical batch composition. karras=True swaps the
uniform skip list for the Karras rho-7 list of as many steps (not ddpm).

Data-parallel serving (num_devices n > 1, sdm_tpu engine.py:119-130): each
bundle entry has one replica per device (parallel/mesh.py::Replicas), and
every U-Net call of the padded batch splits its rows over them, launched
on every device from this one thread. The sampler's own arithmetic and
draws (_noise_for's noise, DDPM's z) stay whole on the first device, so
the images equal the one-device run's. n must divide max_batch and be at
most the visible CUDA count; with device="cpu", n replicas share the CPU.

The engine runs on CUDA unless the caller passes device="cpu".
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from sdm_tpu_torch.diffusion.guidance import cfg_model_fn
from sdm_tpu_torch.diffusion.samplers import (cold_sample, ddim_sample,
                                              ddpm_sample, dpmpp_sample,
                                              heun_sample,
                                              karras_steps_matching)
from sdm_tpu_torch.io.bundles import build_model_from_bundle, load_bundle_config
from sdm_tpu_torch.ops.resize import area_resize
from sdm_tpu_torch.parallel.mesh import Replicas, sampling_devices


@dataclass
class EngineStats:
    batches: int = 0
    images: int = 0
    padded_images: int = 0
    device_seconds: float = 0.0
    compile_seconds: float = 0.0
    lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def snapshot(self) -> dict:
        with self.lock:
            return {"batches": self.batches, "images": self.images,
                    "padded_images": self.padded_images,
                    "device_seconds": round(self.device_seconds, 4),
                    "compile_seconds": round(self.compile_seconds, 4)}


def resolve_device(device=None) -> torch.device:
    """None means the CUDA device, and raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the port runs on the GPU; "
                               "pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


class SamplerEngine:
    """Ensemble sampling chain over one exported bundle."""

    def __init__(self, config_path: str, *, diff_alg: str = "ddim",
                 step_size: int = 10, max_T: int = 1000,
                 max_batch: int = 8, dtype: Optional[str] = None,
                 use_ema: bool = False, guidance: bool = False,
                 num_devices: Optional[int] = None,
                 output_dtype: str = "float32",
                 karras: bool = False, device=None, log=print):
        if diff_alg not in ("ddim", "ddpm", "cold", "dpmpp", "heun"):
            raise ValueError(
                f"diff_alg must be ddim/ddpm/cold/dpmpp/heun, "
                f"got {diff_alg!r}")
        if karras and diff_alg == "ddpm":
            raise ValueError("karras spacing applies to skip-list samplers "
                             "(ddim/dpmpp/heun/cold), not ddpm")
        if output_dtype not in ("float32", "uint8"):
            raise ValueError(
                f"output_dtype must be float32/uint8, got {output_dtype!r}")
        self.device = resolve_device(device)
        self.devices = sampling_devices(self.device, num_devices or 1,
                                        int(max_batch))
        self._out_u8 = output_dtype == "uint8"
        self.max_batch = int(max_batch)
        self.step_size = int(step_size)
        self.guidance = bool(guidance)
        self.stats = EngineStats()
        self._log = log

        models_details, folder = load_bundle_config(config_path)
        first = models_details["models"][0]
        self.img_shape = (first["img_H"], first["img_W"], first["img_C"])
        self.cond_dim = first["cond_dim"]
        if "cond_t" in first:
            self.kind = "sr"           # SR bundles carry cond_t per entry
            self.diff_alg = "cold"     # SR sampling is always cold
        elif diff_alg == "cold":
            self.kind = "cold"
            self.diff_alg = "cold"
        else:
            self.kind = "eps"
            self.diff_alg = diff_alg
        if guidance and self.cond_dim is None:
            raise ValueError("guidance=True needs a label-conditional bundle")
        if guidance and self.kind != "eps":
            raise ValueError(
                "guidance is supported for eps (BASE ddim/ddpm) bundles "
                "only — cold/SR models predict x0, where CFG extrapolation "
                "is not the reference-compatible formulation")
        compute_dtype = torch.bfloat16 if dtype == "bfloat16" else None

        self._entries = []
        for model_dict in models_details["models"]:
            net, schedule = build_model_from_bundle(
                model_dict, folder, max_T=max_T, device=self.device,
                dtype=compute_dtype, cast_params=compute_dtype is not None,
                param_key="ema" if use_ema else "model")
            mn, mx = model_dict["min_noise"], model_dict["max_noise"]
            self._entries.append(dict(
                name=model_dict["model_name"],
                net=Replicas(net, self.devices) if len(self.devices) > 1
                else net, schedule=schedule,
                min_noise=mn, max_noise=mx, cond_t=model_dict.get("cond_t"),
                steps=(karras_steps_matching(mn, mx, self.step_size,
                                             schedule) if karras else None)))

    # ------------------------------------------------------------- sampling

    def _noise_for(self, seed: int, n: int) -> torch.Tensor:
        """A request's initial noise: (n, H, W, C) fp32 on the device, a
        function of (seed, n) only."""
        h, w, c = self.img_shape
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        return torch.randn((n, h, w, c), generator=gen, device=self.device,
                           dtype=torch.float32)

    def _run_entry(self, entry, x_t, labels, generator, noise, cond, gs):
        # The U-Net itself is the model_fn; it carries a v-bundle's tag.
        model_fn = cfg_model_fn(entry["net"], gs) if self.guidance \
            else entry["net"]
        span = dict(min_noise=entry["min_noise"],
                    max_noise=entry["max_noise"])
        if self.diff_alg == "cold":
            return cold_sample(model_fn, entry["schedule"], x_t, noise,
                               skip_step_size=self.step_size,
                               steps=entry["steps"], cond_img=cond,
                               labels=labels, **span)
        if self.diff_alg == "ddim":
            return ddim_sample(model_fn, entry["schedule"], x_t,
                               ddim_step_size=self.step_size,
                               steps=entry["steps"], labels=labels, **span)
        if self.diff_alg in ("dpmpp", "heun"):
            sample = dpmpp_sample if self.diff_alg == "dpmpp" else heun_sample
            return sample(model_fn, entry["schedule"], x_t,
                          step_size=self.step_size, steps=entry["steps"],
                          labels=labels, **span)
        return ddpm_sample(model_fn, entry["schedule"], x_t,
                           generator=generator, labels=labels, **span)

    def generate(self, num_images: int = 1, *, seed: int = 0,
                 labels: Optional[List[float]] = None,
                 guidance_scale: float = 1.0,
                 lr_image: Optional[np.ndarray] = None) -> np.ndarray:
        """One request -> (num_images, H, W, C) images: float in [-1, 1], or
        uint8 in [0, 255] when built with output_dtype="uint8".

        SR bundles require `lr_image` (H_lr, W_lr, C) in [-1, 1]; it is
        shared by the request's num_images (each gets its own noise)."""
        req = dict(num_images=num_images, seed=seed, labels=labels,
                   guidance_scale=guidance_scale, lr_image=lr_image)
        return self.generate_batch([req])[0]

    def generate_batch(self, requests: List[dict]) -> List[np.ndarray]:
        """Coalesced requests -> one padded trajectory chain. Each request:
        {num_images, seed, labels (cond_dim list | None), guidance_scale,
        lr_image (SR only)}."""
        return self.finalize(self.dispatch(requests))

    def dispatch(self, requests: List[dict]):
        """Enqueue all device work for one batch and start the copy of the
        result to pinned host memory; returns a handle for finalize()."""
        if not requests:
            return None
        total = sum(r["num_images"] for r in requests)
        if total > self.max_batch:
            raise ValueError(
                f"batch of {total} exceeds max_batch={self.max_batch}")
        scales = {float(r.get("guidance_scale", 1.0)) for r in requests}
        if len(scales) > 1:
            raise ValueError("coalesced requests must share guidance_scale")
        gs = scales.pop()
        if gs != 1.0 and not self.guidance:
            raise ValueError(
                "engine built without guidance=True cannot apply "
                f"guidance_scale={gs}")
        h, w, c = self.img_shape
        pad = self.max_batch - total
        label_parts = []
        for r in requests:
            if self.cond_dim is not None:
                lab = r.get("labels")
                if lab is None or len(lab) != self.cond_dim:
                    raise ValueError(
                        f"bundle needs {self.cond_dim} labels per request")
                label_parts.append(np.tile(np.asarray(lab, np.float32),
                                           (r["num_images"], 1)))
        lr_images = ([self.check_lr_image(r.get("lr_image"))
                      for r in requests] if self.kind == "sr" else [])

        t0 = time.monotonic()
        with torch.inference_mode():
            parts = [self._noise_for(int(r.get("seed", 0)), r["num_images"])
                     for r in requests]
            if pad:
                parts.append(torch.zeros((pad, h, w, c), dtype=torch.float32,
                                         device=self.device))
            noise = torch.cat(parts) if len(parts) > 1 else parts[0]
            labels = None
            if self.cond_dim is not None:
                lab = np.concatenate(
                    label_parts + [np.zeros((pad, self.cond_dim), np.float32)])
                labels = torch.from_numpy(lab).to(self.device)
            upsampled = cond = None
            if self.kind == "sr":
                # Per-request LR sizes may differ: each is upsampled to the
                # model's size (torch area semantics) before padding. The
                # conditioning is built once, from the first entry's
                # schedule and cond_t, and reused across the ensemble.
                ups = [area_resize(torch.from_numpy(lr[None]).to(
                    self.device), h, w).expand(r["num_images"], h, w, c)
                    for lr, r in zip(lr_images, requests)]
                if pad:
                    ups.append(torch.zeros((pad, h, w, c),
                                           dtype=torch.float32,
                                           device=self.device))
                upsampled = torch.cat(ups)
                e0 = self._entries[0]
                cond = e0["schedule"].q_sample(upsampled, [e0["cond_t"]],
                                               noise)
            generator = torch.Generator(device=self.device).manual_seed(
                int(requests[0].get("seed", 0)))
            x_t, x0 = noise, None
            for entry in self._entries:
                if x0 is not None:
                    # Cold and SR chaining: re-degrade the previous x0 to
                    # this model's max_noise with the shared noise.
                    x_t = entry["schedule"].q_sample(
                        x0, [entry["max_noise"]], noise)
                out = self._run_entry(entry, x_t, labels, generator, noise,
                                      cond, gs)
                if self.kind == "eps":
                    x_t = out
                else:
                    x0 = out
            if self.kind == "sr":
                out = upsampled + out       # the delta model's output
            if self._out_u8:
                out = torch.clamp((out + 1.0) * 127.5, 0, 255).to(torch.uint8)
            event = None
            if self.device.type == "cuda":
                host = torch.empty(out.shape, dtype=out.dtype,
                                   pin_memory=True)
                host.copy_(out, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
                out = host
        return dict(out=out, event=event, requests=requests, total=total,
                    t0=t0)

    def check_lr_image(self, lr) -> np.ndarray:
        """A request's SR input as a float32 copy; raises ValueError unless
        it is (H_lr, W_lr, C) within the model's size."""
        h, w, c = self.img_shape
        lr = None if lr is None else np.asarray(lr, np.float32)
        if lr is None or lr.ndim != 3 or lr.shape[-1] != c:
            raise ValueError(
                f"SR bundle requests need lr_image (H, W, {c}) in [-1, 1]")
        if lr.shape[0] > h or lr.shape[1] > w:
            raise ValueError(f"lr_image {lr.shape[:2]} exceeds the model's "
                             f"output {h}x{w}")
        return lr.copy()

    def finalize(self, handle) -> List[np.ndarray]:
        """Wait for a dispatched batch and slice it per request."""
        if handle is None:
            return []
        if handle["event"] is not None:
            handle["event"].synchronize()
        out = handle["out"].numpy()
        dt = time.monotonic() - handle["t0"]
        total = handle["total"]
        with self.stats.lock:
            self.stats.batches += 1
            self.stats.images += total
            self.stats.padded_images += self.max_batch - total
            self.stats.device_seconds += dt
        results, off = [], 0
        for r in handle["requests"]:
            results.append(out[off:off + r["num_images"]].copy())
            off += r["num_images"]
        return results

    def generate_pipelined(self, request_batches: List[List[dict]],
                           depth: int = 2) -> List[List[np.ndarray]]:
        """Run many batches with up to `depth` dispatched before the oldest
        is finalized. Results in order."""
        if depth < 1:
            raise ValueError("depth must be >= 1")
        handles, results = [], []
        for reqs in request_batches:
            handles.append(self.dispatch(reqs))
            if len(handles) >= depth:
                results.append(self.finalize(handles.pop(0)))
        while handles:
            results.append(self.finalize(handles.pop(0)))
        return results

    def precompile(self) -> float:
        """Warm-up: one full batch and one coalesced two-request batch, so
        the first real request pays no kernel build or cuDNN selection.
        Returns the wall seconds spent and resets the serving stats."""
        h, w, c = self.img_shape
        t0 = time.monotonic()
        req = dict(num_images=self.max_batch, seed=0,
                   labels=([0.0] * self.cond_dim
                           if self.cond_dim is not None else None),
                   guidance_scale=1.0,
                   lr_image=(np.zeros((h // 2, w // 2, c), np.float32)
                             if self.kind == "sr" else None))
        self.generate_batch([req])
        if self.max_batch >= 2:
            half = dict(req, num_images=1)
            self.generate_batch([half, dict(half, seed=1)])
        dt = time.monotonic() - t0
        with self.stats.lock:
            self.stats.compile_seconds = dt
            self.stats.batches = 0
            self.stats.images = 0
            self.stats.padded_images = 0
            self.stats.device_seconds = 0.0
        self._log(f"precompile: {dt:.1f}s "
                  f"(batch {self.max_batch}, {self.kind}/{self.diff_alg})")
        return dt
