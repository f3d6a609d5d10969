"""Image generation from exported bundles by DDPM or DDIM, with ensemble
chaining (port of sdm_tpu/cli/generate_images_diffusion.py).

The bundle's models run in order, each over its own [min_noise, max_noise]
range, and each passes its x_t on to the next. A conditioning image
(--cond_img_path, or `cond_img=` a numpy array from a programmatic caller)
is normalized to [-1, 1] and concatenated onto x_t along channels at every
model call, as the doodle models take it. Images come back as NHWC BGR
floats in [-1, 1], or are saved as one grid under the reference's naming.

    python -m sdm_tpu_torch.cli.generate_images_diffusion \\
        -c exports/base/config.json -n 16 --diff_alg ddim \\
        --ddim_step_size 20 --dtype bfloat16 -s 0

Runs on the CUDA device unless --device cpu. Flags whose samplers or
parallel paths the port lacks raise NotImplementedError naming their
ROADMAP Queue 1 item (`refuse_unported`).
"""

from __future__ import annotations

import argparse
import os
import pathlib

import numpy as np

from sdm_tpu_torch.cli.generate_sr_images_diffusion import (
    SUPPORTED_IMG_FORMATS, _detect_img_format, entry_labels, finish_images)

EXTENSIONS = "ROADMAP Queue 1 item 6 (extensions)"
PARALLEL = "ROADMAP Queue 1 item 9 (parallel)"


def refuse_unported(args: dict) -> None:
    """Raise NotImplementedError for a set flag the port lacks."""
    asked = (
        (f"--diff_alg {args['diff_alg']}",
         args["diff_alg"] in ("dpmpp", "heun"), EXTENSIONS),
        ("--karras", args["karras"], EXTENSIONS),
        ("--init_img_path/--init_noise_step",
         args["init_img_path"] is not None
         or args["init_noise_step"] is not None, EXTENSIONS),
        ("--inpaint_img_path/--inpaint_mask_path",
         args["inpaint_img_path"] is not None
         or args["inpaint_mask_path"] is not None, EXTENSIONS),
        ("--guidance-scale other than 1", args["guidance_scale"] != 1.0,
         EXTENSIONS),
        ("--num-devices > 1",
         args["num_devices"] is not None and args["num_devices"] > 1,
         PARALLEL),
        ("--sp > 1", args["sp"] > 1, PARALLEL),
        ("--pipeline", args["pipeline"] is not None, PARALLEL),
    )
    for flag, on, item in asked:
        if on:
            raise NotImplementedError(
                f"{flag} is not ported to sdm_tpu_torch yet ({item})")


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Generate Images using Diffusion models.")
    parser.add_argument("--device", choices=["cpu", "cuda"], default="cuda",
                        help="Torch device (default the CUDA device).")
    parser.add_argument("--num-devices", type=int, default=None,
                        help="Data-parallel devices (not ported: more than "
                             "one is refused).")
    parser.add_argument("-c", "--config", required=True, type=pathlib.Path,
                        help="File path to config file.")
    parser.add_argument("-s", "--seed", type=int, default=None,
                        help="Seed value for generating image(default: None).")
    parser.add_argument("-n", "--num_images", default=1, type=int,
                        help="Number of images to generate(default=1).")
    parser.add_argument("-d", "--dest_path", type=pathlib.Path,
                        help="File path to save images generated (Default: "
                             "./plots).")
    parser.add_argument("--diff_alg", default="ddpm",
                        choices=["ddpm", "ddim", "dpmpp", "heun"],
                        help="Diffusion Sampling Algorithm to use (default: "
                             "ddpm; dpmpp and heun are not ported).")
    parser.add_argument("--ddim_step_size", default=10, type=int,
                        help="Number of steps to skip when using ddim.")
    parser.add_argument("--karras", action="store_true",
                        help="Karras step spacing (not ported).")
    parser.add_argument("-T", "--max_T", default=1_000, type=int,
                        help="Max T value for noise scheduling (In cases of "
                             "Ensemble methods).")
    parser.add_argument("--cond_img_path", type=pathlib.Path, default=None,
                        help="File path to conditional image e.g Doodle "
                             "image.")
    parser.add_argument("--init_img_path", type=pathlib.Path, default=None,
                        help="img2img start image (not ported).")
    parser.add_argument("--init_noise_step", type=int, default=None,
                        help="Noise level for --init_img_path (not ported).")
    parser.add_argument("--inpaint_img_path", type=pathlib.Path,
                        default=None, help="Inpainting image (not ported).")
    parser.add_argument("--inpaint_mask_path", type=pathlib.Path,
                        default=None, help="Inpainting mask (not ported).")
    parser.add_argument("-l", "--labels", nargs="*", type=float, default=None,
                        help="Conditional Labels.")
    parser.add_argument("--dtype", choices=["float32", "bfloat16"],
                        default="float32",
                        help="Compute dtype; bfloat16 also stores the "
                             "weights in bf16.")
    parser.add_argument("--guidance-scale", type=float, default=1.0,
                        help="Classifier-free guidance scale (1.0 = off; "
                             "other values are not ported).")
    parser.add_argument("--use-ema", action="store_true",
                        help="Sample from the EMA weights stored in the "
                             "checkpoint (training config \"ema_decay\").")
    parser.add_argument("--sp", type=int, default=1, metavar="N",
                        help="Spatial partitioning (not ported: more than "
                             "one is refused).")
    parser.add_argument("--pipeline", type=int, default=None, metavar="M",
                        help="Pipeline-parallel ensemble sampling (not "
                             "ported).")
    return parser


def generate_images_diffusion(raw_args=None, log=print, cond_img=None,
                              save_locally=True, noise=None, zs=None):
    """`cond_img`: a numpy (H, W, C) image in [0, 255], BGR, instead of
    --cond_img_path. `noise`: a numpy (num_images, img_H, img_W, img_C)
    array to use as x_T instead of drawing it from the seed. `zs`: for
    DDPM, one numpy (num_steps, num_images, img_H, img_W, img_C) array of
    per-step noise for each bundle model, instead of drawing it."""
    import torch

    from sdm_tpu_torch.diffusion.samplers import ddim_sample, ddpm_sample
    from sdm_tpu_torch.io.bundles import (build_model_from_bundle,
                                          load_bundle_config)
    from sdm_tpu_torch.serving.engine import resolve_device

    args = vars(_parser().parse_args(raw_args))
    refuse_unported(args)
    device = resolve_device("cpu" if args["device"] == "cpu" else None)
    seed = (args["seed"] if args["seed"] is not None
            else np.random.SeedSequence().entropy % (2 ** 32))
    generator = torch.Generator(device=device).manual_seed(int(seed))

    if args["num_images"] <= 0:
        raise ValueError("Invalid image numbers, should be greater than 0!")
    if args["dest_path"] is None:
        out_dir = "./"
    else:
        if not args["dest_path"].exists():
            raise ValueError(
                "Invalid destination path, kindly correct and ensure it "
                "exists!")
        out_dir = str(args["dest_path"])
    if args["diff_alg"] == "ddim" and (args["ddim_step_size"] < 0 or
                                       args["ddim_step_size"] > args["max_T"]):
        raise ValueError("Invalid step size for DDIM!")

    cond_img_path = args["cond_img_path"]
    if cond_img_path is not None:
        if not os.path.isfile(cond_img_path):
            raise FileNotFoundError(
                "Invalid path for conditional image, kindly correct and try "
                "again!")
        if _detect_img_format(cond_img_path) not in SUPPORTED_IMG_FORMATS:
            raise ValueError("Image format is not supported!")
        import cv2
        cond_img = cv2.imread(str(cond_img_path))
    cond = None
    if cond_img is not None:
        if not isinstance(cond_img, np.ndarray):
            raise ValueError("Unsupported conditional image.")
        cond_img = (cond_img.astype(np.float32) - 127.5) / 127.5  # HWC BGR
        cond = torch.from_numpy(np.repeat(cond_img[None], args["num_images"],
                                          axis=0)).to(device)

    models_details, folder = load_bundle_config(args["config"])
    compute_dtype = torch.bfloat16 if args["dtype"] == "bfloat16" else None
    x_t = None
    img_h = img_w = None
    num_models = len(models_details["models"])
    with torch.inference_mode():
        for model_index, model_dict in enumerate(models_details["models"]):
            log(f"Sampling model {model_index + 1} / {num_models}: "
                f"{model_dict['model_name']} "
                f"[{model_dict['min_noise']}..{model_dict['max_noise']}]")
            if x_t is None:
                img_c, img_h, img_w = (model_dict["img_C"],
                                       model_dict["img_H"],
                                       model_dict["img_W"])
                shape = (args["num_images"], img_h, img_w, img_c)
                if noise is not None:
                    x_t = torch.tensor(np.asarray(noise, np.float32),
                                       device=device)
                    if tuple(x_t.shape) != shape:
                        raise ValueError(f"noise must be {shape}")
                else:
                    x_t = torch.randn(shape, generator=generator,
                                      device=device)
            labels = entry_labels(
                args, model_dict, device,
                message="Invalid / No conditional labels passed!")
            net, schedule = build_model_from_bundle(
                model_dict, folder, max_T=args["max_T"], device=device,
                dtype=compute_dtype, cast_params=compute_dtype is not None,
                param_key="ema" if args["use_ema"] else "model")
            if args["diff_alg"] == "ddpm":
                model_zs = (None if zs is None else torch.tensor(
                    np.asarray(zs[model_index], np.float32), device=device))
                x_t = ddpm_sample(net, schedule, x_t, generator=generator,
                                  min_noise=model_dict["min_noise"],
                                  max_noise=model_dict["max_noise"],
                                  cond_img=cond, labels=labels, zs=model_zs)
            else:
                x_t = ddim_sample(net, schedule, x_t,
                                  min_noise=model_dict["min_noise"],
                                  max_noise=model_dict["max_noise"],
                                  ddim_step_size=args["ddim_step_size"],
                                  cond_img=cond, labels=labels)
        x_t = x_t.cpu().numpy()
    return finish_images(x_t, img_h, img_w, out_dir, log, save_locally)


def run(raw_args=None):
    return generate_images_diffusion(raw_args)


if __name__ == "__main__":
    run()
