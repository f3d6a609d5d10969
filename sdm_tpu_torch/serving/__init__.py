"""Serving: SamplerEngine and the HTTP DiffusionServer."""

from sdm_tpu_torch.serving.engine import SamplerEngine
from sdm_tpu_torch.serving.server import DiffusionServer

__all__ = ["SamplerEngine", "DiffusionServer"]
