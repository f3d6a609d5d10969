"""Inference model bundles (port of sdm_tpu/io/bundles.py).

A bundle directory holds `config.json` with a "models" list plus one
checkpoint .pt per model (cli/export_models.py). This loader reads both
reference-written and sdm_tpu-written bundles: their checkpoints are
`{"model": <torch state_dict>, ...}` in the reference's names, which the
port's UNet loads strictly.

As in sdm_tpu, the default fp32 path runs no kernel (the plain PyTorch
versions, the reference's inference numerics); a compute dtype turns the
kernels on. Entries with "objective": "V" are v-models: the returned U-Net
carries `model_output = "v"`, the tag the samplers read
(diffusion/vpred.py).
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import torch

from sdm_tpu_torch.io.checkpoint import load_checkpoint
from sdm_tpu_torch.models import UNet
from sdm_tpu_torch.ops.schedules import make_schedule


def load_bundle_config(config_path: str) -> Tuple[dict, str]:
    with open(config_path, "r") as f:
        models_details = json.load(f)
    if "models" not in models_details or len(models_details["models"]) == 0:
        raise ValueError(
            "Invalid/no model details in json, kindly correct and try again!")
    folder, _ = os.path.split(str(config_path))
    return models_details, folder


def build_model_from_bundle(model_dict: dict, bundle_folder: str, *,
                            max_T: int, device, dtype=None,
                            cast_params: bool = False,
                            param_key: str = "model",
                            use_kernels: bool = True):
    """Returns (model, schedule) for one bundle entry: the UNet in eval
    mode on `device` with its checkpoint loaded, and the schedule rebuilt
    from the bundle's parameters.

    `dtype` is the compute dtype (None = fp32). `cast_params=True` also
    stores the weights in that dtype (sampling never updates them).
    `param_key="ema"` loads the EMA weights stored beside "model". The
    kernels run with a compute dtype and `use_kernels`
    (sdm_tpu/io/bundles.py:101-110; the generators pass False under
    --sp)."""
    schedule = make_schedule(
        str(model_dict["noise_scheduler"]),
        # BASE-COLD LINEAR bundles written by the reference lack
        # beta_1/beta_T; fall back to the wizard defaults as sdm_tpu does.
        beta_1=model_dict.get("beta_1", 5e-3),
        beta_T=model_dict.get("beta_T", 9e-3),
        max_noise_step=max_T, device=device)
    net = UNet.from_config(model_dict, dtype=dtype,
                           use_kernels=dtype is not None and use_kernels)
    model_path = os.path.join(bundle_folder, model_dict["model_name"])
    if not os.path.isfile(model_path):
        raise FileNotFoundError(
            "Invalid path for model in json file, kindly correct and try again!")
    ok, ckpt = load_checkpoint(model_path, log=lambda *a, **k: None)
    if not ok:
        raise RuntimeError(f"Failed to load model {model_path}")
    if param_key not in ckpt:
        raise ValueError(
            f"checkpoint {model_dict['model_name']} has no '{param_key}' "
            "weights (was it trained with ema_decay set?)")
    net.load_state_dict(ckpt[param_key], strict=True)
    if cast_params and dtype is not None:
        net = net.to(dtype)
    # channels_last conv weights match the channels_last activations.
    net = net.to(device, memory_format=torch.channels_last).eval()
    for p in net.parameters():
        p.requires_grad_(False)
    if str(model_dict.get("objective", "EPS")).upper() == "V":
        net.model_output = "v"
    return net, schedule
