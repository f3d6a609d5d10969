"""Super-resolution generation from exported SR bundles, the second stage of
the cascaded pipeline (port of sdm_tpu/cli/generate_sr_images_diffusion.py).

Loads an LR image (CLI path, or a numpy array from a programmatic caller),
area-upsamples it to the model's img_H x img_W, builds the conditioning by
q-sampling the upsampled image at the first entry's cond_t with the shared
noise, runs cold sampling with that conditioning through the ensemble (each
later entry starts from the previous delta re-degraded to its max_noise),
and returns or saves `upsampled + delta`.

    python -m sdm_tpu_torch.cli.generate_sr_images_diffusion \\
        -c exports/sr/config.json --lr_img_path lr.png --cold_step_size 20 \\
        --dtype bfloat16 -s 0

Runs on the CUDA device unless --device cpu. --num-devices N samples
data-parallel: a replica of each model per card, the LR images' rows
split over them (default: the most visible cards that divide the number
of LR images; with --device cpu, N replicas on the CPU). --sp N splits
every U-Net activation along H over N ranks (`spatial_launch`), the one
way to spread a single image over several cards.
"""

from __future__ import annotations

import argparse
import importlib
import os
import pathlib
import sys
import uuid
from datetime import datetime

import numpy as np

# The port's own copies of sdm_tpu/cli/generate_images_diffusion.py's image
# sniffing (stdlib imghdr is gone in Python 3.13).
SUPPORTED_IMG_FORMATS = ["jpeg", "jpg", "png"]


def _detect_img_format(path) -> str:
    with open(path, "rb") as f:
        head = f.read(12)
    if head.startswith(b"\xff\xd8\xff"):
        return "jpeg"
    if head.startswith(b"\x89PNG\r\n\x1a\n"):
        return "png"
    return "unknown"


def add_sampling_args(parser: argparse.ArgumentParser) -> None:
    """The options the SR and cold generators share."""
    parser.add_argument("--device", choices=["cpu", "cuda"], default="cuda",
                        help="Torch device (default the CUDA device).")
    parser.add_argument("-c", "--config", required=True, type=pathlib.Path,
                        help="File path to load config file.")
    parser.add_argument("-s", "--seed", type=int, default=None,
                        help="Seed value for generating image(default: None).")
    parser.add_argument("-T", "--max_T", default=1_000, type=int,
                        help="Max T value for noise scheduling(In cases of "
                             "Ensemble methods).")
    parser.add_argument("-d", "--dest_path", type=pathlib.Path,
                        help="File path to save images generated (Default: "
                             "./plots).")
    parser.add_argument("--cold_step_size", default=10, type=int,
                        help="Number of steps to skip when using cold "
                             "diffusion.")
    parser.add_argument("-l", "--labels", nargs="*", type=float, default=None,
                        help="Conditional Labels.")
    parser.add_argument("--dtype", choices=["float32", "bfloat16"],
                        default="float32",
                        help="Compute dtype; bfloat16 also stores the "
                             "weights in bf16.")
    parser.add_argument("--use-ema", action="store_true",
                        help="Sample from the EMA weights stored in the "
                             "checkpoint (training config \"ema_decay\").")
    add_parallel_args(parser)


def add_parallel_args(parser: argparse.ArgumentParser) -> None:
    """--num-devices and --sp, which every generator takes."""
    parser.add_argument("--num-devices", type=int, default=None,
                        help="Data-parallel devices: a replica of each model "
                             "per card, the batch's rows split over them "
                             "(default: the most visible cards that divide "
                             "the batch).")
    parser.add_argument("--sp", type=int, default=1, metavar="N",
                        help="Spatial partitioning: every U-Net activation "
                             "split along H over N devices, one process "
                             "each, the batch's rows over the rest of "
                             "--num-devices (default: the most cards that "
                             "divide the batch; with --device cpu, N "
                             "processes). The kernels are off.")


def spatial_launch(fn, raw_args, args: dict, batch: int, models: dict,
                   log, save_locally: bool, **kwargs):
    """Run generator `fn` under --sp, sdm_tpu's sampling_put_fn rule: dp =
    --num-devices / sp, or the most devices dividing `batch` (--device cpu:
    --num-devices defaults to sp); the image height, and every level's of
    each bundle model, must divide by sp. Spawns dp * sp ranks
    (parallel/multihost.py::spawn), each running `fn` with the same
    arguments, a fixed seed (so each draws the one-device run's noise) and
    its ("data", "model", "space") mesh as `spatial_mesh`, with which
    `replicated` gives it a SpatialModel. Returns rank 0's images (or None
    when it saved them)."""
    import torch

    from sdm_tpu_torch.parallel import multihost as mh
    from sdm_tpu_torch.parallel import sp as sp_mod
    from sdm_tpu_torch.serving.engine import resolve_device
    device = resolve_device("cpu" if args["device"] == "cpu" else None)
    num_devices = args["num_devices"]
    if device.type == "cpu":
        num_devices = num_devices or args["sp"]
        available = num_devices
    else:
        available = torch.cuda.device_count()
    dp, sp = sp_mod.auto_dp_sp(batch, num_devices, args["sp"], available)
    first = models["models"][0]
    sp_mod.validate_spatial_divisibility(
        (batch, first["img_H"], first["img_W"], first["img_C"]), sp)
    for md in models["models"]:
        sp_mod.check_levels(md["img_H"], md["num_layers"], sp)
    seed = (args["seed"] if args["seed"] is not None
            else np.random.SeedSequence().entropy % (2 ** 32))
    raw = list(sys.argv[1:] if raw_args is None else raw_args)
    log(f"Spatial partitioning: {dp * sp} ranks ({dp} data x {sp} space), "
        "kernels off")
    return mh.spawn(_run_rank, dp * sp, device.type, device.type, sp,
                    fn.__module__, fn.__name__, raw + ["-s", str(int(seed))],
                    kwargs, save_locally)


def _run_rank(device_type: str, sp: int, module: str, name: str, raw_args,
              kwargs, save_locally):
    from sdm_tpu_torch.parallel import multihost as mh
    from sdm_tpu_torch.parallel.mesh import make_model_mesh
    mesh = make_model_mesh(device_type, 1, sp)
    fn = getattr(importlib.import_module(module), name)
    return fn(raw_args, log=lambda *a, **k: None,
              save_locally=save_locally and mh.is_main_process(),
              spatial_mesh=mesh, **kwargs)


def replicated(net, device, args: dict, batch: int, spatial_mesh=None):
    """`net`, or its Replicas over --num-devices devices for a batch of
    `batch` rows; in a rank of `spatial_launch` (`spatial_mesh`, its
    parallel/mesh.py ModelMesh), its SpatialModel."""
    from sdm_tpu_torch.parallel.mesh import Replicas, sampling_devices
    if spatial_mesh is not None:
        from sdm_tpu_torch.parallel.sp import SpatialModel
        return SpatialModel(net, spatial_mesh)
    devices = sampling_devices(device, args["num_devices"], batch)
    return Replicas(net, devices) if len(devices) > 1 else net


def sampling_setup(args: dict):
    """(device, generator, out_dir, compute dtype) from the shared options,
    with the reference's validation."""
    import torch

    from sdm_tpu_torch.serving.engine import resolve_device
    device = resolve_device("cpu" if args["device"] == "cpu" else None)
    seed = (args["seed"] if args["seed"] is not None
            else np.random.SeedSequence().entropy % (2 ** 32))
    generator = torch.Generator(device=device).manual_seed(int(seed))
    if args["dest_path"] is None:
        out_dir = "./"
    else:
        if not args["dest_path"].exists():
            raise ValueError("Invalid destination path!")
        out_dir = str(args["dest_path"])
    if args["cold_step_size"] < 0 or args["cold_step_size"] > args["max_T"]:
        raise ValueError("Invalid step size for Cold Diffusion!")
    dtype = torch.bfloat16 if args["dtype"] == "bfloat16" else None
    return device, generator, out_dir, dtype


def entry_labels(args: dict, model_dict: dict, device,
                 message: str = "Invalid/No conditional labels passed!"):
    """The entry's conditional labels as a (cond_dim,) tensor, or None;
    ValueError(message) when -l does not give cond_dim of them."""
    import torch
    if model_dict["cond_dim"] is None:
        return None
    if args["labels"] is None or len(args["labels"]) != model_dict["cond_dim"]:
        raise ValueError(message)
    return torch.tensor(args["labels"], dtype=torch.float32, device=device)


def finish_images(images, img_h, img_w, out_dir, log, save_locally):
    """Return the images, or save them as one grid named after the time,
    the size and a random id (the reference's naming) and return None."""
    from sdm_tpu_torch.io.plotting import plot_sampled_images
    if save_locally:
        datetime_now = datetime.now().strftime("%d-%m-%Y %H:%M:%S")
        unique_name = (datetime_now + "_" + f"({img_h},{img_w})" + "_"
                       + uuid.uuid4().hex)
        plot_sampled_images(images, unique_name, dest_path=out_dir, log=log)
        return None
    return images


def generate_sr_images_diffusion(raw_args=None, log=print, lr_img=None,
                                 save_locally=True, noise=None,
                                 spatial_mesh=None):
    """`lr_img`: a numpy (H, W, C) or (N, H, W, C) image in [0, 255], BGR,
    instead of --lr_img_path. `noise`: a numpy (N, img_H, img_W, img_C)
    array to use as the shared noise instead of drawing it from the seed.
    `spatial_mesh`: a rank's mesh, passed by `spatial_launch` (--sp)."""
    import torch

    from sdm_tpu_torch.diffusion.samplers import cold_sample
    from sdm_tpu_torch.io.bundles import (build_model_from_bundle,
                                          load_bundle_config)
    from sdm_tpu_torch.ops.resize import area_resize

    parser = argparse.ArgumentParser(
        description="Generate Super-Resolution Images using Diffusion models.")
    add_sampling_args(parser)
    parser.add_argument("--lr_img_path", type=pathlib.Path, default=None,
                        help="File path to low resolution image.")
    args = vars(parser.parse_args(raw_args))
    device, generator, out_dir, compute_dtype = sampling_setup(args)
    lr_img_arg = lr_img

    if lr_img is not None:
        if not type(lr_img).__module__ == np.__name__:
            raise ValueError("Invalid low resolution image passed!")
    else:
        lr_img_path = args["lr_img_path"]
        if (lr_img_path is None or not os.path.isfile(lr_img_path)
                or _detect_img_format(lr_img_path)
                not in SUPPORTED_IMG_FORMATS):
            raise ValueError(
                "Invalid/No path for low resolution image or unsupported "
                "image.")
        import cv2
        lr_img = cv2.imread(str(lr_img_path))

    lr_img = (lr_img.astype(np.float32) - 127.5) / 127.5   # HWC BGR
    if lr_img.ndim == 3:
        lr_img = lr_img[None]                               # (1, H, W, C)
    lr = torch.from_numpy(np.ascontiguousarray(lr_img)).to(device)

    models_details, folder = load_bundle_config(args["config"])
    if args["sp"] > 1 and spatial_mesh is None:
        return spatial_launch(generate_sr_images_diffusion, raw_args, args,
                              lr.shape[0], models_details, log, save_locally,
                              lr_img=lr_img_arg, noise=noise)
    shared = delta = upsampled = cond = None
    img_h = img_w = None
    num_models = len(models_details["models"])
    with torch.inference_mode():
        for model_index, model_dict in enumerate(models_details["models"]):
            log(f"Sampling model {model_index + 1} / {num_models}: "
                f"{model_dict['model_name']} "
                f"[{model_dict['min_noise']}..{model_dict['max_noise']}]")
            net, schedule = build_model_from_bundle(
                model_dict, folder, max_T=args["max_T"], device=device,
                dtype=compute_dtype, cast_params=compute_dtype is not None,
                param_key="ema" if args["use_ema"] else "model",
                use_kernels=args["sp"] == 1)
            if shared is None:
                img_c, img_h, img_w = (model_dict["img_C"],
                                       model_dict["img_H"],
                                       model_dict["img_W"])
                shape = (lr.shape[0], img_h, img_w, img_c)
                if noise is not None:
                    shared = torch.tensor(np.asarray(noise, np.float32),
                                          device=device)
                    if tuple(shared.shape) != shape:
                        raise ValueError(f"noise must be {shape}")
                else:
                    shared = torch.randn(shape, generator=generator,
                                         device=device)
                x_t = shared
                if img_h < lr.shape[1] or img_w < lr.shape[2]:
                    raise ValueError("Invalid shapes for High Resolution and "
                                     "Low Resolution images.")
                upsampled = area_resize(lr, img_h, img_w)
                cond = schedule.q_sample(upsampled, [model_dict["cond_t"]],
                                         shared)
            else:
                x_t = schedule.q_sample(delta, [model_dict["max_noise"]],
                                        shared)
            labels = entry_labels(args, model_dict, device)
            delta = cold_sample(replicated(net, device, args, lr.shape[0],
                                           spatial_mesh),
                                schedule, x_t, shared,
                                min_noise=model_dict["min_noise"],
                                max_noise=model_dict["max_noise"],
                                skip_step_size=args["cold_step_size"],
                                cond_img=cond, labels=labels)
        x0 = (upsampled + delta).cpu().numpy()
    return finish_images(x0, img_h, img_w, out_dir, log, save_locally)


def run(raw_args=None):
    return generate_sr_images_diffusion(raw_args)


if __name__ == "__main__":
    run()
