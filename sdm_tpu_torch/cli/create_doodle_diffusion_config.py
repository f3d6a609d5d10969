"""Write a doodle training config by prompts (the reference's
create_doodle_diffusion_config.py), for train_doodle_diffusion:
`python -m sdm_tpu_torch.cli.create_doodle_diffusion_config`."""

from sdm_tpu_torch.cli.config_wizards import create_doodle_diffusion_config


def run():
    create_doodle_diffusion_config()


if __name__ == "__main__":
    run()
