"""Write a super-resolution training config by prompts (the reference's
create_sr_diffusion_config.py), for train_SR_diffusion:
`python -m sdm_tpu_torch.cli.create_sr_diffusion_config`."""

from sdm_tpu_torch.cli.config_wizards import create_sr_diffusion_config


def run():
    create_sr_diffusion_config()


if __name__ == "__main__":
    run()
