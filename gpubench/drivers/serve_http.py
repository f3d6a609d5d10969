"""Driver `serve_http`: the program's HTTP server (DiffusionServer over a
SamplerEngine) serving a bundle written from the seeded weights, under a
closed loop of clients in a process of their own (http_clients.py).

Set-up: the kernels built, the weights made on the device, the bundle
written to TMPDIR and loaded by the engine (then deleted), the server
started with its precompile (one full batch and one coalesced batch, the
only shape the padded engine runs). The window opens when the clients
start and lasts `seconds`; requests sent in it and still open at its close
are waited for (they count in the latency, not in the images per second).
A traced run keeps the clients sending after the window and, once every
request sent in the window is answered, profiles the server's device
worker for `trace_seconds` under that same load (the profiler's start
stalls the worker for seconds, and no request of the window waits on
it), then stops the clients; the window's numbers are those of an
untraced run.

The check: a sample drawn from the seed of the answered requests whose
images the clients kept, the largest among them, up to `check_images`
images, against the plain float32 sampler over the same noise (each
request's noise is a function of its seed: a generator on the device
seeded with it). The number compared is `image_gap`, the largest over the
images of |served - reference| / |reference - base| (norms over the
image; base is what the sampler returns where the model adds nothing: the
upsampled LR image for the SR stage, the scaled noise for DDIM).
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

from gpubench import flops, harness, traffic
from gpubench.counters import Counts
from gpubench.reference import diffusion as ref
from gpubench.reference.unet import strict_fp32
from gpubench.trace import OnThread, Tracer

CLIENTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "http_clients.py")
WAIT_AFTER_S = 120.0


def write_bundle(folder: str, cfg: dict, params) -> str:
    """The bundle config.json + checkpoint of one entry over steps
    1..max_noise_step, in the exported schema; returns config.json."""
    import torch
    name = f"{cfg['name']}_1-{cfg['max_noise_step']}.pt"
    torch.save({"model": {k: v.cpu() for k, v in params.items()}},
               os.path.join(folder, name))
    entry = {"model_name": name, "img_C": 3, "img_H": cfg["image_size"],
             "img_W": cfg["image_size"], "in_channel": cfg["in_channel"],
             "out_channel": cfg["out_channel"],
             "num_layers": cfg["num_layers"],
             "num_resnet_block": cfg["num_resnet_blocks"],
             "attn_layers": cfg["attn_layers"],
             "attn_heads": cfg["num_heads"],
             "attn_dim_per_head": cfg["dim_per_head"],
             "time_dim": cfg["time_dim"], "cond_dim": cfg["cond_dim"],
             "min_channel": cfg["min_channel"],
             "max_channel": cfg["max_channel"],
             "image_recon": cfg["image_recon"],
             "max_noise": cfg["max_noise_step"], "min_noise": 1,
             "noise_scheduler": cfg["noise_scheduler"],
             "beta_1": cfg["beta_1"], "beta_T": cfg["beta_T"]}
    if cfg.get("cond_t") is not None:
        entry["cond_t"] = cfg["cond_t"]
    path = os.path.join(folder, "config.json")
    with open(path, "w") as f:
        json.dump({"models": [entry]}, f)
    return path


def sample(requests: list, seed: int, budget: int) -> list:
    """A sample drawn from the seed of the kept, answered requests: the
    largest first, then others while the images fit in `budget`."""
    rng = np.random.default_rng([int(seed), 7])
    pool = [requests[i] for i in rng.permutation(len(requests))]
    pool.sort(key=lambda r: -r["num_images"])
    out, total = [], 0
    for r in pool:
        if total + r["num_images"] <= budget or not out:
            out.append(r)
            total += r["num_images"]
    return out


def reference_images(cfg: dict, wl: dict, seed: int, params, reqs: list,
                     device, quant=None):
    """[(images, base)] of the plain sampler for each request of `reqs`
    ({"client", "k", "num_images", "seed"}), all in one batch."""
    import torch
    h = w = cfg["image_size"]
    abar = ref.alpha_bar(cfg["beta_1"], cfg["beta_T"],
                         cfg["max_noise_step"], device)
    steps = ref.skip_steps(1, cfg["max_noise_step"], wl["step_size"])
    noise = []
    for r in reqs:
        gen = torch.Generator(device=device).manual_seed(r["seed"])
        noise.append(torch.randn((r["num_images"], h, w, 3), generator=gen,
                                 device=device, dtype=torch.float32))
    noise = torch.cat(noise)
    with torch.no_grad(), strict_fp32():
        if wl["mix"].get("lr_size"):
            lr = torch.cat([torch.from_numpy(traffic.lr_image(
                wl["mix"], seed, r["client"], r["k"]))[None].expand(
                    r["num_images"], -1, -1, -1) for r in reqs]).to(device)
            base = ref.area(lr, h, w)
            out = ref.sr_sample(params, cfg, abar, noise, lr, steps,
                                cfg["cond_t"], quant)
        else:
            # Where the model adds nothing (eps = 0), DDIM returns the
            # noise over sqrt(alpha_bar_T): the part of the image that the
            # gap is not measured against.
            base = noise / abar[steps[0]] ** 0.5
            out = ref.ddim(params, cfg, abar, noise, steps, quant)
    res, off = [], 0
    for r in reqs:
        n = r["num_images"]
        res.append((out[off:off + n].cpu().numpy(),
                    base[off:off + n].cpu().numpy()))
        off += n
    return res


def image_gap(got: np.ndarray, want: np.ndarray, base: np.ndarray) -> float:
    """Largest over the images of |got - want| / |want - base|."""
    g = got.reshape(got.shape[0], -1).astype(np.float64)
    wv = want.reshape(want.shape[0], -1).astype(np.float64)
    b = base.reshape(base.shape[0], -1).astype(np.float64)
    return float(np.max(np.linalg.norm(g - wv, axis=1)
                        / np.linalg.norm(wv - b, axis=1)))


def start_server(cfg, wl, params, device, tmp, counts, mark):
    from sdm_tpu_torch.serving import DiffusionServer, SamplerEngine
    folder = os.path.join(tmp, "bundle")
    os.makedirs(folder)
    config_path = write_bundle(folder, cfg, params)
    mark("bundle_written")
    try:
        engine = SamplerEngine(config_path, diff_alg=wl["sampler"],
                               step_size=wl["step_size"],
                               max_batch=wl["max_batch"], dtype=cfg["dtype"],
                               device=device, log=lambda *a: None)
    finally:
        shutil.rmtree(folder)
    mark("engine_loaded")
    for entry in engine._entries:
        counts.watch(entry["net"])
    server = DiffusionServer(engine, port=0,
                             batch_wait_ms=wl["batch_wait_ms"],
                             log=lambda *a: None)
    server.start(precompile=True)
    mark("precompiled")
    return server


def run(ctx: dict) -> dict:
    import torch
    spec, seed, seconds = ctx["spec"], ctx["seed"], ctx["seconds"]
    cfg, wl, device = spec["config"], spec["workload"], ctx["device"]
    phases = {}

    def mark(name):
        phases[name] = ctx["clock"].since()

    counts = Counts()
    params = harness.make_params(cfg, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    mark("weights")
    tmp = tempfile.mkdtemp(prefix="gpubench_serve_")
    server = proc = None
    try:
        server = start_server(cfg, wl, params, device, tmp, counts, mark)
        del params
        if ctx.get("fault"):
            ctx["fault"](server)
        engine = server.engine
        tracer = Tracer(counts.read) if ctx["trace"] else None
        args = {"url": f"http://{server.host}:{server.port}/generate",
                "mix": wl["mix"], "seed": seed, "seconds": seconds,
                "hold": bool(ctx["trace"]), "out": tmp}
        proc = subprocess.Popen([sys.executable, CLIENTS, json.dumps(args)],
                                stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE, text=True)
        line = proc.stdout.readline().split()
        if not line or line[0] != "start":
            raise RuntimeError("the client process did not start")
        t0 = float(line[1])
        setup_s = ctx["clock"].since() - (time.monotonic() - t0)
        phases["clients"] = setup_s
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        stats0 = engine.stats.snapshot()
        time.sleep(max(0.0, t0 + seconds - time.monotonic()))
        stats1 = engine.stats.snapshot()
        peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
                else 0)
        if ctx["trace"]:
            # Traced on the server's device worker once the window's
            # requests are answered, with the clients still sending.
            if proc.stdout.readline().strip() != "drained":
                raise RuntimeError("the clients did not report the window "
                                   "answered")
            hook = OnThread(tracer, engine, "dispatch")
            if not hook.ask("start", WAIT_AFTER_S):
                tracer = None
            else:
                time.sleep(wl["trace_seconds"])
                if not hook.ask("stop", WAIT_AFTER_S):
                    raise RuntimeError("the traced window did not close")
        proc.stdin.close()
        proc.stdout.read()
        proc.wait(timeout=WAIT_AFTER_S)
        server.stop()
        server = None
        del engine
        if device.type == "cuda":
            torch.cuda.empty_cache()
        with open(os.path.join(tmp, "requests.json")) as f:
            log = json.load(f)
        result = judge_requests(cfg, wl, seed, seconds, device, log, t0, tmp)
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        if server is not None:
            server.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    engine_window = {k: stats1[k] - stats0[k]
                     for k in ("batches", "images", "padded_images")}
    h = cfg["image_size"]
    result["record"].update(
        engine=engine_window, window_s=float(seconds),
        calls_per_chain=len(ref.skip_steps(1, cfg["max_noise_step"],
                                           wl["step_size"])),
        forward_flops=flops.unet_forward_flops(cfg, h, h, 1, 1),
        kernel_work=flops.kernel_work(cfg, h, h, wl["max_batch"], 2,
                                      flops.WHOLE_S_MAX, backward=False))
    result.update(setup_s=setup_s, peak_bytes=peak, phases=phases,
                  trace=tracer.summary() if tracer is not None else None)
    return result


def judge_requests(cfg, wl, seed, seconds, device, log, t0, tmp) -> dict:
    """Metrics of the window from the clients' log (the requests sent in
    it), and the check of a sample of their kept answers against the
    reference. A request that failed, sent in the window or after it,
    fails the check."""
    end = t0 + seconds
    window = [e for e in log if e[3] < end]
    lat = [(e[4] - e[3]) if e[5] else float("inf") for e in window]
    images = sum(e[2] for e in window if e[5] and e[4] <= end)
    failed = [e for e in log if not e[5]]
    kept = []
    for c, k, n, _, _, ok, _ in window:
        path = os.path.join(tmp, f"c{c}_k{k}.npy")
        if ok and os.path.exists(path):
            req = traffic.request(wl["mix"], seed, c, k)
            kept.append({"client": c, "k": k, "num_images": n,
                         "seed": req["seed"], "path": path})
    gap = None           # no kept answer: nothing checked, not correct
    if kept:
        params = harness.make_params(cfg, seed, device)
        reqs = sample(kept, seed, wl["check_images"])
        refs = reference_images(cfg, wl, seed, params, reqs, device)
        gap = max(image_gap(np.load(r["path"]), want, base)
                  for r, (want, base) in zip(reqs, refs))
    checks = {"image_gap": {"value": gap,
                            "limit": wl["checks"]["image_gap"]},
              "requests_failed": {"value": len(failed), "limit": 0}}
    p95 = harness.percentile(lat, 95.0)
    metrics = {"served_img_per_s": images / seconds}
    return {"metrics": metrics, "attempted": len(window),
            "failed": sum(1 for e in window if not e[5]), "checks": checks,
            "errors": [e[6] for e in failed[:3]],
            "record": {"images": images, "chips": 1,
                       "request_p95_s": p95 if math.isfinite(p95) else None}}
