"""Export trained checkpoints into inference bundles (port of the
programmatic half of sdm_tpu/cli/export_models.py: `_bundle_entry` and
`export_bundle`; the interactive prompt is not ported).

A bundle is a directory holding `config.json` with a "models" list and one
checkpoint .pt per model, named `{name}_{min}-{max}.pt`. As in sdm_tpu,
beta_1/beta_T are written for every model type.
"""

from __future__ import annotations

import json
import os
import shutil


def _bundle_entry(config_name: str, config_dict: dict, *, img_c: int,
                  img_h: int, img_w: int, model_type: str) -> dict:
    """The bundle `config.json` model schema (key for key with the
    reference export_models.py:60-103)."""
    min_step = config_dict["min_noise_step"]
    max_step = config_dict["max_noise_step"]
    entry = {
        "model_name": f"{config_name}_{min_step}-{max_step}.pt",
        "img_C": img_c, "img_H": img_h, "img_W": img_w,
        "in_channel": config_dict["in_channel"],
        "out_channel": config_dict["out_channel"],
        "num_layers": config_dict["num_layers"],
        "num_resnet_block": config_dict["num_resnet_block"],
        "attn_layers": config_dict["attn_layers"],
        "attn_heads": config_dict["attn_heads"],
        "attn_dim_per_head": config_dict["attn_dim_per_head"],
        "time_dim": config_dict["time_dim"],
        "cond_dim": config_dict["cond_dim"],
        "min_channel": config_dict["min_channel"],
        "max_channel": config_dict["max_channel"],
        "image_recon": config_dict["img_recon"],
        "max_noise": max_step,
        "min_noise": min_step,
        "noise_scheduler": config_dict["noise_scheduler"],
        "beta_1": config_dict["beta1"],
        "beta_T": config_dict["betaT"],
    }
    if model_type == "SR":
        entry["cond_t"] = config_dict["cond_t"]
    if str(config_dict.get("objective", "")).upper() == "V":
        entry["objective"] = "V"
    return entry


def export_bundle(config_name: str, export_dest_path: str, *, img_c: int,
                  img_h: int, img_w: int, model_type: str, entries) -> str:
    """`entries` is a list of (training_config_dict, checkpoint_path).
    Copies each checkpoint into `{dest}/{config_name}/`, writes its
    config.json, and returns the bundle directory."""
    new_dest_path = os.path.join(export_dest_path, config_name)
    os.makedirs(new_dest_path, exist_ok=True)
    json_vals = {"models": []}
    for config_dict, model_path in entries:
        entry = _bundle_entry(config_name, config_dict, img_c=img_c,
                              img_h=img_h, img_w=img_w, model_type=model_type)
        json_vals["models"].append(entry)
        shutil.copy(model_path, os.path.join(new_dest_path,
                                             entry["model_name"]))
    with open(os.path.join(new_dest_path, "config.json"), "w") as f:
        json.dump(json_vals, f)
    return new_dest_path
