"""The conditional U-Net (torch.nn)."""

from sdm_tpu_torch.models.unet import UNet

__all__ = ["UNet"]
