"""Write a base diffusion training config by prompts (the reference's
create_diffusion_config.py), for train_diffusion, train_noise_cold_diffusion:
`python -m sdm_tpu_torch.cli.create_diffusion_config`."""

from sdm_tpu_torch.cli.config_wizards import create_diffusion_config


def run():
    create_diffusion_config()


if __name__ == "__main__":
    run()
