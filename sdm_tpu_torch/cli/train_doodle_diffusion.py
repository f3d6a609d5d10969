"""Train a doodle-conditioned diffusion model (the reference's
train_doodle_diffusion.py): `python -m
sdm_tpu_torch.cli.train_doodle_diffusion -c cfg.json [--device cpu]
[--steps N]`. Runs on CUDA unless --device cpu is given."""

from sdm_tpu_torch.train.loop import DOODLE_SPEC, main


def run(raw_args=None):
    return main(DOODLE_SPEC, raw_args)


if __name__ == "__main__":
    run()
