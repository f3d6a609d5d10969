"""Serving CLI (port of sdm_tpu/cli/serve_diffusion.py): keep an exported
bundle resident on the GPU and serve /generate over HTTP with request
micro-batching.

  python -m sdm_tpu_torch.cli.serve_diffusion -c exports/model/config.json \\
      --port 8000 --diff_alg ddim --ddim_step_size 20 --max-batch 16 \\
      --dtype bfloat16

  curl -s localhost:8000/generate -d '{"num_images": 2, "seed": 7}'

BASE bundles take --diff_alg ddim/ddpm/dpmpp/heun/cold (cold for
BASE-COLD bundles), --karras spacing (not with ddpm) and, for
label-conditional bundles, --guidance: requests then pass
"guidance_scale". SR bundles (entries with cond_t) always sample cold, with
--cold_step_size, and each request carries its low-resolution image
("lr_image_b64" + "lr_shape", or "lr_image_png_b64"; see
serving/server.py). --num-devices N > 1 serves data-parallel: one replica
of each model per card, each batch's rows split over them (N must divide
--max-batch).
"""

from __future__ import annotations

import argparse
import sys
import threading


def serve_diffusion(raw_args=None, log=print, block: bool = True):
    parser = argparse.ArgumentParser(
        description="Serve an exported diffusion bundle over HTTP.")
    parser.add_argument("-c", "--config", required=True,
                        help="Bundle config.json (export_models output).")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000,
                        help="0 = pick a free port (printed at startup).")
    parser.add_argument("--diff_alg", default="ddim",
                        choices=("ddim", "ddpm", "cold", "dpmpp", "heun"),
                        help="Sampler for BASE bundles (SR bundles always "
                             "sample cold; dpmpp = 2nd-order ODE solver, "
                             "one model call per step; heun = 2nd-order "
                             "predictor-corrector, two per step).")
    parser.add_argument("--ddim_step_size", "--cold_step_size",
                        dest="ddim_step_size", type=int, default=10,
                        help="Skip-step size of the ddim, dpmpp, heun "
                             "and cold step lists.")
    parser.add_argument("-T", "--max_T", type=int, default=1000)
    parser.add_argument("--max-batch", type=int, default=8,
                        help="Batch shape; requests coalesce and pad up to "
                             "this.")
    parser.add_argument("--batch-wait-ms", type=float, default=20.0,
                        help="How long the worker waits for more requests "
                             "to coalesce once one is in hand.")
    parser.add_argument("--dtype", default="float32",
                        choices=("float32", "bfloat16"),
                        help="bfloat16 computes and stores the weights in "
                             "bf16.")
    parser.add_argument("--use-ema", action="store_true",
                        help="Serve the EMA weights (training ema_decay).")
    parser.add_argument("--guidance", action="store_true",
                        help="Classifier-free guidance (label-conditional "
                             "bundles): requests may pass guidance_scale.")
    parser.add_argument("--uint8-output", action="store_true",
                        help="Quantize images to uint8 on the device.")
    parser.add_argument("--num-devices", type=int, default=None,
                        help="Data-parallel devices: a replica per card, "
                             "each batch's rows split over them (default "
                             "1).")
    parser.add_argument("--karras", action="store_true",
                        help="Karras rho-7 step spacing, as many steps as "
                             "the uniform skip list (ddim/dpmpp/heun/cold).")
    parser.add_argument("--device", default=None,
                        help="Torch device; default the CUDA device (the "
                             "CPU only when asked: --device cpu).")
    parser.add_argument("--no-precompile", action="store_true",
                        help="Skip the warm-up batch (the first request "
                             "pays the kernel build).")
    args = parser.parse_args(raw_args)

    from sdm_tpu_torch.serving import DiffusionServer, SamplerEngine
    engine = SamplerEngine(
        args.config, diff_alg=args.diff_alg,
        step_size=args.ddim_step_size, max_T=args.max_T,
        max_batch=args.max_batch,
        dtype=args.dtype if args.dtype != "float32" else None,
        use_ema=args.use_ema, guidance=args.guidance,
        num_devices=args.num_devices,
        output_dtype="uint8" if args.uint8_output else "float32",
        karras=args.karras, device=args.device, log=log)
    server = DiffusionServer(engine, host=args.host, port=args.port,
                             batch_wait_ms=args.batch_wait_ms, log=log)
    server.start(precompile=not args.no_precompile)
    if not block:
        return server
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        log("shutting down")
        server.stop()


def run():
    serve_diffusion(log=lambda *a, **k: print(*a, file=sys.stderr, **k))


if __name__ == "__main__":
    run()
