"""Cold-diffusion image generation from exported bundles (port of
sdm_tpu/cli/generate_images_cold_diffusion.py).

The initial noise is shared by the whole trajectory; ensemble chaining
re-degrades the previous model's x0 to the next model's max_noise with it.
BASE-COLD LINEAR bundles written by the reference lack beta_1/beta_T; the
bundle loader falls back to the wizard defaults, as sdm_tpu does.

    python -m sdm_tpu_torch.cli.generate_images_cold_diffusion \\
        -c exports/cold/config.json -n 4 --cold_step_size 20 -s 0

--karras spaces the steps by Karras et al.'s rho-7 rule, as many as the
uniform skip list (as sdm_tpu's generator does). Runs on the CUDA device
unless --device cpu. --num-devices N samples data-parallel (a replica of
each model per card, the batch's rows split over them; default: the most
visible cards that divide -n); --sp N splits every U-Net activation
along H over N ranks (generate_sr_images_diffusion.py::spatial_launch).
"""

from __future__ import annotations

import argparse
import uuid
from datetime import datetime

import numpy as np

from sdm_tpu_torch.cli.generate_sr_images_diffusion import (
    add_sampling_args, entry_labels, replicated, sampling_setup,
    spatial_launch)


def generate_images_cold_diffusion(raw_args=None, log=print,
                                   save_locally=True, noise=None,
                                   spatial_mesh=None):
    """`noise`: a numpy (num_images, img_H, img_W, img_C) array to use as
    the shared noise instead of drawing it from the seed. `spatial_mesh`:
    a rank's mesh, passed by `spatial_launch` (--sp)."""
    import torch

    from sdm_tpu_torch.diffusion.samplers import (cold_sample,
                                                  karras_steps_matching)
    from sdm_tpu_torch.io.bundles import (build_model_from_bundle,
                                          load_bundle_config)
    from sdm_tpu_torch.io.plotting import plot_sampled_images

    parser = argparse.ArgumentParser(
        description="Generate Images using Cold Diffusion models.")
    add_sampling_args(parser)
    parser.add_argument("-n", "--num_images", default=1, type=int,
                        help="Number of images to generate(default=1).")
    parser.add_argument("--karras", action="store_true",
                        help="Karras rho-7 step spacing: as many steps as "
                             "the uniform skip list, concentrated at low "
                             "noise.")
    args = vars(parser.parse_args(raw_args))
    if args["num_images"] <= 0:
        raise ValueError("Invalid image numbers, should be greater than 0!")
    device, generator, out_dir, compute_dtype = sampling_setup(args)

    models_details, folder = load_bundle_config(args["config"])
    if args["sp"] > 1 and spatial_mesh is None:
        return spatial_launch(generate_images_cold_diffusion, raw_args, args,
                              args["num_images"], models_details, log,
                              save_locally, noise=noise)
    shared = x0 = None
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
                shape = (args["num_images"], img_h, img_w, img_c)
                if noise is not None:
                    shared = torch.tensor(np.asarray(noise, np.float32),
                                          device=device)
                    if tuple(shared.shape) != shape:
                        raise ValueError(f"noise must be {shape}")
                else:
                    shared = torch.randn(shape, generator=generator,
                                         device=device)
                x_t = shared
            else:
                x_t = schedule.q_sample(x0, [model_dict["max_noise"]], shared)
            steps = (karras_steps_matching(
                model_dict["min_noise"], model_dict["max_noise"],
                args["cold_step_size"], schedule) if args["karras"] else None)
            x0 = cold_sample(replicated(net, device, args,
                                        args["num_images"], spatial_mesh),
                             schedule, x_t, shared,
                             min_noise=model_dict["min_noise"],
                             max_noise=model_dict["max_noise"],
                             skip_step_size=args["cold_step_size"],
                             steps=steps,
                             labels=entry_labels(args, model_dict, device))
        x0 = x0.cpu().numpy()
    if save_locally:
        datetime_now = datetime.now().strftime("%d-%m-%Y %H:%M:%S")
        unique_name = (datetime_now + f"({img_h},{img_w})" + "_"
                       + uuid.uuid4().hex)
        plot_sampled_images(x0, unique_name, dest_path=out_dir, log=log)
        return None
    return x0


def run(raw_args=None):
    return generate_images_cold_diffusion(raw_args)


if __name__ == "__main__":
    run()
