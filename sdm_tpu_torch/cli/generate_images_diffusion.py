"""Image generation from exported bundles by DDPM, DDIM, DPM-Solver++(2M)
or Heun, with ensemble chaining (port of
sdm_tpu/cli/generate_images_diffusion.py).

The bundle's models run in order, each over its own [min_noise, max_noise]
range, and each passes its x_t on to the next. A conditioning image
(--cond_img_path, or `cond_img=` a numpy array from a programmatic caller)
is normalized to [-1, 1] and concatenated onto x_t along channels at every
model call, as the doodle models take it. Images come back as NHWC BGR
floats in [-1, 1], or are saved as one grid under the reference's naming.

    python -m sdm_tpu_torch.cli.generate_images_diffusion \\
        -c exports/base/config.json -n 16 --diff_alg dpmpp --karras \\
        --ddim_step_size 20 --dtype bfloat16 -s 0

As in sdm_tpu: --karras spaces the ddim/dpmpp/heun steps by Karras et al.'s
rho-7 rule; --init_img_path/--init_noise_step start the first model from
the image q-sampled to that step (img2img); --inpaint_img_path with
--inpaint_mask_path keeps the mask's white pixels and synthesizes the rest
(ddim/dpmpp/heun); --guidance-scale extrapolates a label-conditional model
away from its zero-label branch; v-bundles are sampled natively.

Runs on the CUDA device unless --device cpu. --num-devices N samples
data-parallel: a replica of each model per card, the batch's rows split
over them (default: the most visible cards that divide -n; with --device
cpu, N replicas on the CPU). --pipeline M runs an ensemble bundle as a
pipeline: model k on card k mod (the visible count), the batch cut into M
microbatches that stream through the models (parallel/pipeline.py;
`_pipeline_generate`). --sp N splits every U-Net activation along H over
N ranks, the rows over --num-devices / N of them
(generate_sr_images_diffusion.py::spatial_launch); not with --pipeline.
"""

from __future__ import annotations

import argparse
import os
import pathlib

import numpy as np

from sdm_tpu_torch.cli.generate_sr_images_diffusion import (
    SUPPORTED_IMG_FORMATS, _detect_img_format, add_parallel_args,
    entry_labels, finish_images, replicated, spatial_launch)


def check_pipeline(args: dict, num_models: int) -> None:
    """sdm_tpu's checks of --pipeline (generate_images_diffusion.py:
    210-224), in its order."""
    if args["init_img_path"] is not None:
        raise ValueError("--pipeline does not support --init_img_path")
    if args["inpaint_img_path"] is not None:
        raise ValueError("--pipeline does not support inpainting")
    if args["num_devices"] and args["num_devices"] > 1:
        raise ValueError("--pipeline and --num-devices data parallelism "
                         "are mutually exclusive")
    if args["sp"] > 1:
        raise ValueError("--pipeline and --sp spatial partitioning "
                         "are mutually exclusive")
    if num_models < 2:
        raise ValueError("--pipeline needs a multi-model (ensemble) "
                         "bundle; single-model bundles gain nothing")


def microbatch_generator(stage_seed: int, m: int, device):
    """DDPM's noise stream for microbatch m of a pipeline stage (the
    counterpart of sdm_tpu's fold_in(stage_key, m))."""
    import torch
    return torch.Generator(device=device).manual_seed(
        (int(stage_seed) + m) % 2 ** 63)


def _check_image(path, message: str) -> None:
    """sdm_tpu's checks of an image path: FileNotFoundError(message) when
    it is not a file, ValueError when it is not a JPEG or PNG."""
    if not os.path.isfile(path):
        raise FileNotFoundError(message)
    if _detect_img_format(path) not in SUPPORTED_IMG_FORMATS:
        raise ValueError("Image format is not supported!")


def _normalized(img: np.ndarray) -> np.ndarray:
    return (img.astype(np.float32) - 127.5) / 127.5


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Generate Images using Diffusion models.")
    parser.add_argument("--device", choices=["cpu", "cuda"], default="cuda",
                        help="Torch device (default the CUDA device).")
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
                             "ddpm). dpmpp = DPM-Solver++(2M), a 2nd-order "
                             "ODE solver, one model call per step; heun = "
                             "Karras et al. 2022 predictor-corrector, two "
                             "model calls per step.")
    parser.add_argument("--ddim_step_size", default=10, type=int,
                        help="Number of steps to skip when using "
                             "ddim/dpmpp/heun.")
    parser.add_argument("--karras", action="store_true",
                        help="Karras rho-7 step spacing for "
                             "ddim/dpmpp/heun: as many steps as the uniform "
                             "skip list, concentrated at low noise.")
    parser.add_argument("-T", "--max_T", default=1_000, type=int,
                        help="Max T value for noise scheduling (In cases of "
                             "Ensemble methods).")
    parser.add_argument("--cond_img_path", type=pathlib.Path, default=None,
                        help="File path to conditional image e.g Doodle "
                             "image.")
    parser.add_argument("--init_img_path", type=pathlib.Path, default=None,
                        help="img2img: start the reverse chain from this "
                             "image q-sampled to --init_noise_step instead "
                             "of pure noise. Must match the model "
                             "resolution.")
    parser.add_argument("--init_noise_step", type=int, default=None,
                        help="Noise level for --init_img_path (the first "
                             "model samples from this step down). Required "
                             "with --init_img_path.")
    parser.add_argument("--inpaint_img_path", type=pathlib.Path,
                        default=None,
                        help="Inpainting (ddim/dpmpp/heun): keep this "
                             "image's pixels where the mask is white and "
                             "synthesize the rest.")
    parser.add_argument("--inpaint_mask_path", type=pathlib.Path,
                        default=None,
                        help="Mask for --inpaint_img_path: pixels >= 128 "
                             "are kept from the image, < 128 generated. "
                             "Required with --inpaint_img_path.")
    parser.add_argument("-l", "--labels", nargs="*", type=float, default=None,
                        help="Conditional Labels.")
    parser.add_argument("--dtype", choices=["float32", "bfloat16"],
                        default="float32",
                        help="Compute dtype; bfloat16 also stores the "
                             "weights in bf16.")
    parser.add_argument("--guidance-scale", type=float, default=1.0,
                        help="Classifier-free guidance scale for label-"
                             "conditional models (1.0 = off; > 1 "
                             "extrapolates away from the zero-label "
                             "branch).")
    parser.add_argument("--use-ema", action="store_true",
                        help="Sample from the EMA weights stored in the "
                             "checkpoint (training config \"ema_decay\").")
    add_parallel_args(parser)
    parser.add_argument("--pipeline", type=int, default=None, metavar="M",
                        help="Pipeline-parallel ensemble sampling: each "
                             "bundle model on its own device (model k on "
                             "device k mod the visible count), the batch "
                             "split into M microbatches streaming through "
                             "the chain. Needs an ensemble bundle; not "
                             "with --num-devices, --sp, --init_img_path or "
                             "inpainting.")
    return parser


def generate_images_diffusion(raw_args=None, log=print, cond_img=None,
                              save_locally=True, noise=None, zs=None,
                              spatial_mesh=None):
    """`cond_img`: a numpy (H, W, C) image in [0, 255], BGR, instead of
    --cond_img_path. `noise`: a numpy (num_images, img_H, img_W, img_C)
    array to use as x_T instead of drawing it from the seed (img2img and
    inpainting q-sample with it, as with the drawn one). `zs`: for DDPM,
    one numpy (num_steps, num_images, img_H, img_W, img_C) array of
    per-step noise for each bundle model, instead of drawing it.
    `spatial_mesh`: a rank's mesh, passed by `spatial_launch` (--sp)."""
    import torch

    from sdm_tpu_torch.diffusion.guidance import cfg_model_fn
    from sdm_tpu_torch.diffusion.samplers import (ddim_sample, ddpm_sample,
                                                  dpmpp_sample, heun_sample,
                                                  karras_steps_matching)
    from sdm_tpu_torch.io.bundles import (build_model_from_bundle,
                                          load_bundle_config)
    from sdm_tpu_torch.serving.engine import resolve_device

    args = vars(_parser().parse_args(raw_args))
    device = resolve_device("cpu" if args["device"] == "cpu" else None)
    seed = (args["seed"] if args["seed"] is not None
            else np.random.SeedSequence().entropy % (2 ** 32))
    generator = torch.Generator(device=device).manual_seed(int(seed))
    alg = args["diff_alg"]

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
    if alg in ("ddim", "dpmpp", "heun"):
        if args["ddim_step_size"] < 0 or args["ddim_step_size"] > args["max_T"]:
            raise ValueError("Invalid step size for DDIM!")
    elif args["karras"]:
        raise ValueError("--karras applies to --diff_alg ddim/dpmpp/heun")

    cond_img_arg = cond_img
    cond_img_path = args["cond_img_path"]
    if cond_img_path is not None:
        _check_image(cond_img_path, "Invalid path for conditional image, "
                     "kindly correct and try again!")
        import cv2
        cond_img = cv2.imread(str(cond_img_path))
    cond = None
    if cond_img is not None:
        if not isinstance(cond_img, np.ndarray):
            raise ValueError("Unsupported conditional image.")
        cond_img = _normalized(cond_img)  # HWC BGR
        cond = torch.from_numpy(np.repeat(cond_img[None], args["num_images"],
                                          axis=0)).to(device)

    models_details, folder = load_bundle_config(args["config"])
    if args["pipeline"]:
        check_pipeline(args, len(models_details["models"]))
        return _pipeline_generate(args, models_details, folder, generator,
                                  cond, out_dir, log, save_locally, noise)

    # img2img: the init image, validated and read up front.
    init_img = None
    if (args["init_img_path"] is None) != (args["init_noise_step"] is None):
        raise ValueError(
            "--init_img_path and --init_noise_step go together")
    if args["init_img_path"] is not None:
        _check_image(args["init_img_path"],
                     "Invalid path for init image, kindly correct and try "
                     "again!")
        import cv2
        init_img = _normalized(cv2.imread(str(args["init_img_path"])))

    # Inpainting: the known image and its keep-mask.
    inpaint_img = inpaint_mask = None
    if (args["inpaint_img_path"] is None) != (
            args["inpaint_mask_path"] is None):
        raise ValueError(
            "--inpaint_img_path and --inpaint_mask_path go together")
    if args["inpaint_img_path"] is not None:
        if alg not in ("ddim", "dpmpp", "heun"):
            raise ValueError("inpainting is supported with --diff_alg "
                             "ddim/dpmpp/heun")
        if args["init_img_path"] is not None:
            raise ValueError("--inpaint_img_path and --init_img_path are "
                             "mutually exclusive")
        for p in (args["inpaint_img_path"], args["inpaint_mask_path"]):
            _check_image(p, f"Invalid path {p}, kindly correct and try "
                         "again!")
        import cv2
        inpaint_img = _normalized(cv2.imread(str(args["inpaint_img_path"])))
        m = cv2.imread(str(args["inpaint_mask_path"]), cv2.IMREAD_GRAYSCALE)
        inpaint_mask = (m >= 128).astype(np.float32)[..., None]  # (H, W, 1)
        if inpaint_mask.shape[:2] != inpaint_img.shape[:2]:
            raise ValueError(
                f"mask {inpaint_mask.shape[:2]} must match the inpaint "
                f"image {inpaint_img.shape[:2]}")
    if args["sp"] > 1 and spatial_mesh is None:
        return spatial_launch(generate_images_diffusion, raw_args, args,
                              args["num_images"], models_details, log,
                              save_locally, cond_img=cond_img_arg,
                              noise=noise, zs=zs)

    compute_dtype = torch.bfloat16 if args["dtype"] == "bfloat16" else None
    x_t = x_T = None
    ink = {}
    img_h = img_w = None
    num_models = len(models_details["models"])
    with torch.inference_mode():
        for model_index, model_dict in enumerate(models_details["models"]):
            log(f"Sampling model {model_index + 1} / {num_models}: "
                f"{model_dict['model_name']} "
                f"[{model_dict['min_noise']}..{model_dict['max_noise']}]")
            if x_T is None:
                img_c, img_h, img_w = (model_dict["img_C"],
                                       model_dict["img_H"],
                                       model_dict["img_W"])
                shape = (args["num_images"], img_h, img_w, img_c)
                if noise is not None:
                    x_T = torch.tensor(np.asarray(noise, np.float32),
                                       device=device)
                    if tuple(x_T.shape) != shape:
                        raise ValueError(f"noise must be {shape}")
                else:
                    x_T = torch.randn(shape, generator=generator,
                                      device=device)
                x_t = x_T
            labels = entry_labels(
                args, model_dict, device,
                message="Invalid / No conditional labels passed!")
            net, schedule = build_model_from_bundle(
                model_dict, folder, max_T=args["max_T"], device=device,
                dtype=compute_dtype, cast_params=compute_dtype is not None,
                param_key="ema" if args["use_ema"] else "model",
                use_kernels=args["sp"] == 1)

            # img2img: the first model starts from the init image q-sampled
            # to init_noise_step with x_T.
            max_noise = model_dict["max_noise"]
            if model_index == 0 and init_img is not None:
                t0 = int(args["init_noise_step"])
                if not model_dict["min_noise"] < t0 <= max_noise:
                    raise ValueError(
                        f"--init_noise_step {t0} must lie in "
                        f"({model_dict['min_noise']}, {max_noise}]")
                if init_img.shape[:2] != (img_h, img_w):
                    raise ValueError(
                        f"init image {init_img.shape[:2]} must match the "
                        f"model resolution ({img_h}, {img_w})")
                init_b = torch.from_numpy(np.repeat(
                    init_img[None], args["num_images"], axis=0)).to(device)
                x_t = schedule.q_sample(init_b, [t0], x_T)
                max_noise = t0

            if inpaint_img is not None and model_index == 0:
                if inpaint_img.shape[:2] != (img_h, img_w):
                    raise ValueError(
                        f"inpaint image {inpaint_img.shape[:2]} must match "
                        f"the model resolution ({img_h}, {img_w})")
                known = torch.from_numpy(np.repeat(
                    inpaint_img[None], args["num_images"], axis=0)).to(device)
                mask = torch.from_numpy(inpaint_mask).to(device)
                # The known region starts on its forward marginal.
                x_t = ((1.0 - mask) * x_t + mask * schedule.q_sample(
                    known, [max_noise], x_T))
                ink = dict(inpaint_known=known, inpaint_mask=mask,
                           inpaint_noise=x_T)

            gs = args["guidance_scale"]
            if gs != 1.0 and labels is None:
                raise ValueError("--guidance-scale needs a label-conditional "
                                 "model and -l labels")
            model_fn = cfg_model_fn(
                replicated(net, device, args, args["num_images"],
                           spatial_mesh), gs)
            span = dict(min_noise=model_dict["min_noise"],
                        max_noise=max_noise, cond_img=cond, labels=labels)
            steps = (karras_steps_matching(model_dict["min_noise"],
                                           max_noise, args["ddim_step_size"],
                                           schedule)
                     if args["karras"] else None)
            if alg == "ddpm":
                model_zs = (None if zs is None else torch.tensor(
                    np.asarray(zs[model_index], np.float32), device=device))
                x_t = ddpm_sample(model_fn, schedule, x_t,
                                  generator=generator, zs=model_zs, **span)
            elif alg == "ddim":
                x_t = ddim_sample(model_fn, schedule, x_t,
                                  ddim_step_size=args["ddim_step_size"],
                                  steps=steps, **ink, **span)
            else:
                sample = dpmpp_sample if alg == "dpmpp" else heun_sample
                x_t = sample(model_fn, schedule, x_t,
                             step_size=args["ddim_step_size"], steps=steps,
                             **ink, **span)
        x_t = x_t.cpu().numpy()
    return finish_images(x_t, img_h, img_w, out_dir, log, save_locally)


def _pipeline_generate(args, models_details, folder, generator, cond,
                       out_dir, log, save_locally, noise=None):
    """Pipeline-parallel ensemble sampling (sdm_tpu's _pipeline_generate,
    generate_images_diffusion.py:405-511): stage k (bundle model k) lives
    on CUDA device k mod the visible count (every stage on the CPU with
    --device cpu), and --pipeline M microbatches stream through the chain
    (parallel/pipeline.py). x_T is drawn once up front, as the sequential
    path draws it, so DDIM/DPM++/Heun give the sequential images; each
    DDPM stage draws a seed from the run's generator and each microbatch
    its own stream from it (`microbatch_generator`)."""
    import torch

    from sdm_tpu_torch.diffusion.guidance import cfg_model_fn
    from sdm_tpu_torch.diffusion.samplers import (ddim_sample, ddpm_sample,
                                                  dpmpp_sample, heun_sample,
                                                  karras_steps_matching)
    from sdm_tpu_torch.io.bundles import build_model_from_bundle
    from sdm_tpu_torch.parallel.pipeline import pipeline_chain

    models = models_details["models"]
    home = generator.device
    devices = ([torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
               if home.type == "cuda" else [home])
    n_imgs, n_micro = args["num_images"], args["pipeline"]
    alg = args["diff_alg"]
    compute_dtype = torch.bfloat16 if args["dtype"] == "bfloat16" else None
    md0 = models[0]
    img_c, img_h, img_w = md0["img_C"], md0["img_H"], md0["img_W"]
    shape = (n_imgs, img_h, img_w, img_c)
    if noise is not None:
        x_t = torch.tensor(np.asarray(noise, np.float32), device=home)
        if tuple(x_t.shape) != shape:
            raise ValueError(f"noise must be {shape}")
    else:
        x_t = torch.randn(shape, generator=generator, device=home)
    if n_imgs % n_micro != 0:
        raise ValueError(f"--pipeline {n_micro} must divide -n {n_imgs}")
    size = n_imgs // n_micro

    stage_fns, stage_devs = [], []
    for i, model_dict in enumerate(models):
        dev = devices[i % len(devices)]
        log(f"Pipeline stage {i + 1}/{len(models)} on {dev}: "
            f"{model_dict['model_name']} "
            f"[{model_dict['min_noise']}..{model_dict['max_noise']}]")
        labels = entry_labels(args, model_dict, dev,
                              message="Invalid / No conditional labels "
                                      "passed!")
        net, schedule = build_model_from_bundle(
            model_dict, folder, max_T=args["max_T"], device=dev,
            dtype=compute_dtype, cast_params=compute_dtype is not None,
            param_key="ema" if args["use_ema"] else "model")
        gs = args["guidance_scale"]
        if gs != 1.0 and labels is None:
            raise ValueError("--guidance-scale needs a label-conditional "
                             "model and -l labels")
        span = dict(model_fn=cfg_model_fn(net, gs), schedule=schedule,
                    min_noise=model_dict["min_noise"],
                    max_noise=model_dict["max_noise"], labels=labels)
        chunks = (None if cond is None else
                  [cond[m * size:(m + 1) * size].to(dev)
                   for m in range(n_micro)])
        if alg == "ddpm":
            seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                     device=home))

            def stage(xm, m, span=span, chunks=chunks, seed=seed, dev=dev):
                return ddpm_sample(
                    x_t=xm, generator=microbatch_generator(seed, m, dev),
                    cond_img=chunks[m] if chunks else None, **span)
        else:
            sample = {"ddim": ddim_sample, "dpmpp": dpmpp_sample,
                      "heun": heun_sample}[alg]
            step_kw = ({"ddim_step_size": args["ddim_step_size"]}
                       if alg == "ddim"
                       else {"step_size": args["ddim_step_size"]})
            if args["karras"]:
                step_kw["steps"] = karras_steps_matching(
                    model_dict["min_noise"], model_dict["max_noise"],
                    args["ddim_step_size"], schedule)

            def stage(xm, m, span=span, chunks=chunks, sample=sample,
                      step_kw=step_kw):
                return sample(x_t=xm, cond_img=chunks[m] if chunks else None,
                              **span, **step_kw)
        stage_fns.append(stage)
        stage_devs.append(dev)

    with torch.inference_mode():
        x_t = pipeline_chain(stage_fns, stage_devs, x_t, n_micro)
        x_t = x_t.cpu().numpy()
    return finish_images(x_t, img_h, img_w, out_dir, log, save_locally)


def run(raw_args=None):
    return generate_images_diffusion(raw_args)


if __name__ == "__main__":
    run()
