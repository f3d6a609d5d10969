"""Interactive training-config wizards (the port's own copy of
sdm_tpu/cli/config_wizards.py, click prompt flows).

The same prompts in the same order with the same defaults as sdm_tpu's
(and the reference's create_diffusion_config.py,
create_sr_diffusion_config.py and create_doodle_diffusion_config.py), and
the same JSON key for key, so a config written by either package trains in
both. One shared flow, parameterized per wizard kind.

`click` is imported here at module top: the wizards are interactive entry
points, and no training, serving or generation module imports this one.
"""

from __future__ import annotations

import glob
import json
import os

import click


def _prompt_name_dest():
    config_name = click.prompt(
        "Name of model, will be reflected in json file name?", type=str)
    destination_path = click.prompt(
        "Destination path for config file?", type=click.Path(exists=True))
    return os.path.join(destination_path, config_name + ".json")


def _prompt_dataset(json_params, allow_conditional: bool):
    if allow_conditional and click.confirm(
            "Will the model include conditional input for training?"):
        json_params["dataset_path"] = click.prompt(
            "File path to training dataset?", type=click.Path(exists=True))
        json_params["use_conditional"] = True
        json_params["cond_dim"] = click.prompt(
            "Dimension of conditional input vector?",
            type=click.IntRange(min=1), default=1)
    elif allow_conditional:
        json_params["dataset_path"] = click.prompt(
            "Regex to training dataset?", type=str)
        if len(glob.glob(json_params["dataset_path"])) == 0:
            raise TypeError("Invalid Dataset Path passed!")
        json_params["use_conditional"] = False
        json_params["cond_dim"] = None
    else:  # doodle: TinyDB file, conditioning is the doodle image itself
        json_params["dataset_path"] = click.prompt(
            "File path to training dataset?", type=click.Path(exists=True))
        json_params["use_conditional"] = False
        json_params["cond_dim"] = None


def _prompt_training(json_params, *, flip: bool):
    json_params["out_dir"] = click.prompt(
        "Destination path for output?", type=click.Path())
    json_params["checkpoint_steps"] = click.prompt(
        "Steps to be performed before checkpoint?",
        type=click.IntRange(min=1), default=1_000)
    json_params["lr_steps"] = click.prompt(
        "Steps before halving learning rate?",
        type=click.IntRange(min=1), default=100_000)
    json_params["max_epoch"] = click.prompt(
        "Total epoch for training?", type=click.IntRange(min=1), default=1_000)
    json_params["plot_img_count"] = click.prompt(
        "Number of images in sampled ploting grid?",
        type=click.IntRange(min=1), default=10)
    if flip:
        json_params["flip_imgs"] = click.prompt(
            "Randomly flip images horizontally during training (Image Augmentation)?",
            type=bool, default=True)

    if click.confirm("Do you want to load a previous model checkpoint?"):
        json_params["model_checkpoint"] = click.prompt(
            "Model checkpoint?", type=click.Path(exists=True))
        json_params["load_diffusion_optim"] = click.prompt(
            "Load model's checkpoint optim values?", type=bool, default=False)
    else:
        json_params["model_checkpoint"] = None
        json_params["load_diffusion_optim"] = False

    if click.confirm("Do you want to load a previous configuration checkpoint?"):
        json_params["config_checkpoint"] = click.prompt(
            "Config chekpoint?", type=click.Path(exists=True))
    else:
        json_params["config_checkpoint"] = None

    json_params["diffusion_lr"] = click.prompt(
        "Learning Rate for model training?",
        type=click.FloatRange(min=0, min_open=True), default=2e-5)
    json_params["batch_size"] = click.prompt(
        "Batch size for training?", type=click.IntRange(min=1), default=20)


def _prompt_scheduler(json_params):
    json_params["noise_scheduler"] = click.prompt(
        "Noise scheduler to use?",
        type=click.Choice(["LINEAR", "COSINE"], case_sensitive=False),
        default="LINEAR")
    if json_params["noise_scheduler"] == "LINEAR":
        json_params["beta1"] = click.prompt(
            "Beta1 for Linear Noise scheduling?",
            type=click.FloatRange(min=0, min_open=True), default=5e-3)
        json_params["betaT"] = click.prompt(
            "BetaT for Linear Noise scheduling?",
            type=click.FloatRange(min=0, min_open=True), default=9e-3)
    else:
        json_params["beta1"] = 5e-3
        json_params["betaT"] = 9e-3


def _prompt_noise_steps(json_params):
    json_params["min_noise_step"] = click.prompt(
        "Min noise step for diffusion model?",
        type=click.IntRange(min=1), default=1)
    json_params["max_noise_step"] = click.prompt(
        "Max noise step for diffusion model?",
        type=click.IntRange(min=1), default=1_000)
    json_params["max_actual_noise_step"] = click.prompt(
        "Max actual noise step, needed for noise scheduler?",
        type=click.IntRange(min=1), default=1_000)


def _prompt_model(json_params, *, in_channel_default: int,
                  in_channel_min: int, img_recon):
    json_params["in_channel"] = click.prompt(
        "Model In Channel?", type=click.IntRange(min=in_channel_min),
        default=in_channel_default)
    json_params["out_channel"] = click.prompt(
        "Model Out Channel?", type=click.IntRange(min=1), default=3)
    json_params["num_layers"] = click.prompt(
        "Number of layers in model?", type=click.IntRange(min=1), default=4)
    json_params["num_resnet_block"] = click.prompt(
        "Number of Residual layers in each model's layer?",
        type=click.IntRange(min=1), default=1)
    json_params["attn_layers"] = []
    for layer_num in range(json_params["num_layers"]):
        if click.confirm(
                f"Do you want to add attention mechanism in Layer {layer_num} / {json_params['num_layers'] - 1}?"):
            json_params["attn_layers"].append(layer_num)
    json_params["attn_heads"] = click.prompt(
        "Number of attention heads in attention layers?",
        type=click.IntRange(min=1), default=1)
    attn_dim_per_head_val = click.prompt(
        "Dimensions of attention head (-1 for None)?",
        type=click.IntRange(min=-1), default=-1)
    json_params["attn_dim_per_head"] = (
        None if attn_dim_per_head_val == -1 else attn_dim_per_head_val)
    json_params["time_dim"] = click.prompt(
        "Dimension of time conditional input?",
        type=click.IntRange(min=4), default=512)
    json_params["min_channel"] = click.prompt(
        "Minimum channel in model?", type=click.IntRange(min=4), default=128)
    json_params["max_channel"] = click.prompt(
        "Maximum channel in model?", type=click.IntRange(min=4), default=512)
    if img_recon == "prompt_false":
        json_params["img_recon"] = click.prompt(
            "Reconstruct image in final layer (Use Tanh: for cold diffusion)?",
            type=bool, default=False)
    elif img_recon == "prompt_true":
        json_params["img_recon"] = click.prompt(
            "Reconstruct image in final layer (Use Tanh: for cold diffusion)?",
            type=bool, default=True)
    else:
        json_params["img_recon"] = bool(img_recon)


def _save(json_file, json_params):
    try:
        if click.confirm(f"File will be saved in: {json_file}, Are you sure?",
                         default=True):
            with open(json_file, "w") as f:
                json.dump(json_params, f)
            click.echo(f"File saved at: {json_file}")
    except Exception as e:
        click.echo(f"An error occured saving json file: {e}.")


def create_diffusion_config():
    """Base-diffusion wizard (create_diffusion_config.py:7-213)."""
    json_file = _prompt_name_dest()
    json_params = {}
    _prompt_dataset(json_params, allow_conditional=True)
    _prompt_training(json_params, flip=True)
    _prompt_scheduler(json_params)
    json_params["diffusion_alg"] = click.prompt(
        "Diffusion algorithm to use?",
        type=click.Choice(["DDPM", "DDIM", "COLD"], case_sensitive=False),
        default="DDPM")
    if json_params["diffusion_alg"] in ("DDIM", "COLD"):
        json_params["skip_step"] = click.prompt(
            "Number of steps to be skipped in DDIM/COLD sampling?",
            type=click.IntRange(min=1), default=100)
    else:
        json_params["skip_step"] = 100
    _prompt_noise_steps(json_params)
    _prompt_model(json_params, in_channel_default=3, in_channel_min=1,
                  img_recon="prompt_false")
    _save(json_file, json_params)


def create_sr_diffusion_config():
    """SR wizard (create_sr_diffusion_config.py:7-217): adds lr_dim/sr_dim/
    cond_t; always cold (no diffusion_alg); in_channel default 6,
    img_recon default True."""
    json_file = _prompt_name_dest()
    json_params = {}
    json_params["lr_dim"] = click.prompt(
        "Low Resolution Dim?", type=click.IntRange(min=2), default=128)
    json_params["sr_dim"] = click.prompt(
        "Super Resolution Dim?",
        type=click.IntRange(min=json_params["lr_dim"], min_open=True),
        default=256)
    _prompt_dataset(json_params, allow_conditional=True)
    _prompt_training(json_params, flip=True)
    _prompt_scheduler(json_params)
    json_params["skip_step"] = click.prompt(
        "Number of steps to be skipped in COLD sampling?",
        type=click.IntRange(min=1), default=100)
    _prompt_noise_steps(json_params)
    json_params["cond_t"] = click.prompt(
        "Conditional fixed timestep?",
        type=click.IntRange(min=1, max=json_params["max_actual_noise_step"]),
        default=250)
    _prompt_model(json_params, in_channel_default=6, in_channel_min=2,
                  img_recon="prompt_true")
    _save(json_file, json_params)


def create_doodle_diffusion_config():
    """Doodle wizard (create_doodle_diffusion_config.py:6-184): no
    flip/use_conditional (forced), in_channel default 6, img_recon False,
    DDPM/DDIM only."""
    json_file = _prompt_name_dest()
    json_params = {}
    _prompt_dataset(json_params, allow_conditional=False)
    _prompt_training(json_params, flip=False)
    _prompt_scheduler(json_params)
    json_params["diffusion_alg"] = click.prompt(
        "Diffusion algorithm to use?",
        type=click.Choice(["DDPM", "DDIM"], case_sensitive=False),
        default="DDPM")
    if json_params["diffusion_alg"] == "DDIM":
        json_params["skip_step"] = click.prompt(
            "Number of steps to be skipped in DDIM sampling?",
            type=click.IntRange(min=1), default=100)
    else:
        json_params["skip_step"] = 100
    _prompt_noise_steps(json_params)
    _prompt_model(json_params, in_channel_default=6, in_channel_min=2,
                  img_recon=False)
    _save(json_file, json_params)
