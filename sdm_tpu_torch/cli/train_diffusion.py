"""Train a base eps diffusion model (the reference's train_diffusion.py):
`python -m sdm_tpu_torch.cli.train_diffusion -c cfg.json [--device cpu]
[--steps N]`. Runs on CUDA unless --device cpu is given."""

from sdm_tpu_torch.train.loop import BASE_SPEC, main


def run(raw_args=None):
    return main(BASE_SPEC, raw_args)


if __name__ == "__main__":
    run()
