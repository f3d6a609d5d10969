"""Progressive distillation CLI (port of sdm_tpu/cli/distill_diffusion.py).

Takes the training-config JSON of train_diffusion plus a trained eps- or
v-model checkpoint, and halves the student's DDIM grid for `--phases`
rounds (train/distill.py has the math). Each phase writes a
reference-format checkpoint `distilled_ss{N}_{steps}.pt` that exports
through export_models and samples through `generate_images_diffusion
--diff_alg ddim --ddim_step_size N`. Runs on CUDA unless --device cpu:

  python -m sdm_tpu_torch.cli.distill_diffusion -c config.json \\
      --teacher-checkpoint out/checkpoint/diffusion_100000.pt \\
      --start-step-size 20 --phases 4 --steps-per-phase 4000

gives students at step sizes 40, 80, 160, 320 (25, 13, 7, 4 calls).
--num-devices N trains data-parallel on N cards, one process each.
"""

from __future__ import annotations

import argparse
import json
import logging
import pathlib

from sdm_tpu_torch.train.distill import run_distillation
from sdm_tpu_torch.utils import setup_logging


def parse_args(raw_args=None) -> dict:
    parser = argparse.ArgumentParser(
        description="Progressively distill a diffusion model for few-step "
                    "DDIM sampling.")
    parser.add_argument("-c", "--config-path", required=True,
                        type=pathlib.Path,
                        help="File path to load json config file.")
    parser.add_argument("--teacher-checkpoint", required=True, type=str,
                        help="Trained eps-model checkpoint (.pt) to distill.")
    parser.add_argument("--start-step-size", type=int, default=None,
                        help="DDIM step size the teacher samples well at "
                             "(default: the config's skip_step).")
    parser.add_argument("--phases", type=int, default=2,
                        help="Number of grid-halving phases (default 2).")
    parser.add_argument("--steps-per-phase", type=int, default=2000,
                        help="Optimizer steps per phase (default 2000).")
    parser.add_argument("--distill-lr", type=float, default=None,
                        help="Learning rate (default: config diffusion_lr).")
    parser.add_argument("--use-ema-teacher", action="store_true",
                        help="Distill from the checkpoint's EMA weights "
                             "(requires training with config ema_decay).")
    parser.add_argument("--dataset-kind",
                        choices=["auto", "glob", "conditional", "doodle"],
                        default="auto",
                        help="Dataset flavor ('auto' follows the config's "
                             "use_conditional; 'doodle' for doodle-"
                             "conditioned models).")
    parser.add_argument("--device", choices=["cuda", "cpu"], type=str,
                        default="cuda", help="Device to distill on.")
    parser.add_argument("--num-devices", type=int, default=None,
                        help="Data-parallel devices, one process each "
                             "(default: the most visible cards that divide "
                             "the batch; with --device cpu, 1).")
    return vars(parser.parse_args(raw_args))


def run(raw_args=None):
    args = parse_args(raw_args)
    with open(args["config_path"], "r") as f:
        config_dict = json.loads(f.read())
    setup_logging(config_dict["out_dir"], "Distill-Diffusion")
    return run_distillation(
        config_dict,
        teacher_checkpoint=args["teacher_checkpoint"],
        start_step_size=args["start_step_size"],
        phases=args["phases"],
        steps_per_phase=args["steps_per_phase"],
        distill_lr=args["distill_lr"],
        num_devices=args["num_devices"],
        dataset_kind=args["dataset_kind"],
        use_ema_teacher=args["use_ema_teacher"],
        log=logging.info, device=args["device"])


if __name__ == "__main__":
    run()
