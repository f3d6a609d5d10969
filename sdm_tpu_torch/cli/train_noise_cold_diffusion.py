"""Train a cold (x0-predicting) diffusion model (the reference's
train_noise_cold_diffusion.py): `python -m
sdm_tpu_torch.cli.train_noise_cold_diffusion -c cfg.json [--device cpu]
[--steps N]`. Runs on CUDA unless --device cpu is given."""

from sdm_tpu_torch.train.loop import COLD_SPEC, main


def run(raw_args=None):
    return main(COLD_SPEC, raw_args)


if __name__ == "__main__":
    run()
