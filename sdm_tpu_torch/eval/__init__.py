"""Sample-quality evaluation (port of sdm_tpu/eval): Frechet and kernel
distances (fid.py, numpy) between features from features.py (pixel,
sdm_tpu's fixed-seed randconv net, or a user's torch module).

CLI: cli/evaluate_samples.py.
"""

from sdm_tpu_torch.eval.features import make_feature_extractor
from sdm_tpu_torch.eval.fid import (frechet_distance, gaussian_stats,
                                    kernel_distance)

__all__ = ["frechet_distance", "gaussian_stats", "kernel_distance",
           "make_feature_extractor"]
