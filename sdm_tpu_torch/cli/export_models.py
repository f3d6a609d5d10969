"""Export trained checkpoints into inference bundles (port of
sdm_tpu/cli/export_models.py): the interactive prompt (`export_models`,
`python -m sdm_tpu_torch.cli.export_models`) and its programmatic form
(`export_bundle`).

A bundle is a directory holding `config.json` with a "models" list and one
checkpoint .pt per model, named `{name}_{min}-{max}.pt`. As in sdm_tpu,
beta_1/beta_T are written for every model type. The prompt asks what
sdm_tpu's asks, in the same order with the same defaults. It imports
`click` when it runs, so the generators and chip_smoke.py, which import
this module for `export_bundle`, do not need it.
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


def export_models():
    """The interactive export: name, destination, the images' C, H and W,
    the model type, the number of models, then each model's training
    config and checkpoint."""
    import click
    config_name = click.prompt(
        "Config Name (Will be reflected in model names)?", type=str)
    export_dest_path = click.prompt(
        "Destination path for model and config file?",
        type=click.Path(exists=True))

    new_dest_path = os.path.join(export_dest_path, config_name)
    os.makedirs(new_dest_path)

    img_c = click.prompt("Model was trained on images with channel(C)?",
                         type=click.IntRange(min=1), default=3)
    img_h = click.prompt("Model was trained on images with Height (H)?",
                         type=click.IntRange(min=2), default=128)
    img_w = click.prompt("Model was trained on images with Width (W)?",
                         type=click.IntRange(min=2), default=128)

    model_type = click.prompt(
        "Model type?",
        type=click.Choice(["BASE", "BASE-COLD", "SR"], case_sensitive=False),
        default="BASE")
    models_num = click.prompt(
        "How many models do you want to combine (For ensemble diffusion)?",
        type=click.IntRange(min=1), default=1)

    json_vals = {"models": []}
    for model_index in range(models_num):
        click.echo(f"Model: {model_index + 1} / {models_num}")
        config_path = click.prompt("File path to config file?",
                                   type=click.Path(exists=True))
        model_path = click.prompt("File path to model checkpoint?",
                                  type=click.Path(exists=True))
        with open(config_path, "r") as f:
            config_dict = json.loads(f.read())

        entry = _bundle_entry(config_name, config_dict, img_c=img_c,
                              img_h=img_h, img_w=img_w, model_type=model_type)
        json_vals["models"].append(entry)

        dest_path = os.path.join(new_dest_path, entry["model_name"])
        shutil.copy(model_path, dest_path)
        click.echo(f"Successfully copied model file to {dest_path}.")

    json_file = os.path.join(new_dest_path, "config.json")
    with open(json_file, "w") as f:
        json.dump(json_vals, f)
    click.echo(f"Successfully saved {json_file}")


def run():
    export_models()


if __name__ == "__main__":
    run()
