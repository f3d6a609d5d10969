"""Framework vocabulary enums.

Copy of sdm_tpu/enums.py (the port keeps its own). Capability parity with
the reference diffusion_enums.py:5-13 (DiffusionAlg,
NoiseScheduler) and models/custom_layers.py:10-12 (UNetBlockType),
plus the training-objective vocabulary that the reference encodes implicitly in
its four trainer scripts.
"""

from enum import Enum


class DiffusionAlg(Enum):
    DDPM = 0
    DDIM = 1


class NoiseScheduler(Enum):
    LINEAR = 0
    COSINE = 1


class UNetBlockType(Enum):
    UP = 0
    DOWN = 1


class Objective(Enum):
    """What the denoiser is trained to predict.

    EPS          — noise prediction (reference train_diffusion.py:350-352)
    X0           — image reconstruction (reference train_noise_cold_diffusion.py:340-342)
    RESIDUAL_X0  — SR residual reconstruction (reference train_SR_diffusion.py:350,372-374)
    V            — velocity prediction v = sqrt(abar)·eps − sqrt(1−abar)·x0
                   (Salimans & Ho 2022; TPU-build extension, config
                   "objective": "V" on the base trainer — the reference has
                   no v-parameterization; see diffusion/vpred.py)
    """

    EPS = 0
    X0 = 1
    RESIDUAL_X0 = 2
    V = 3
