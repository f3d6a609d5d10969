"""Area (adaptive-average-pool) resize with torch's "area" semantics (port
of sdm_tpu/ops/resize.py).

The SR pipeline area-resizes the low-resolution image up to the model's
output size. torch's `F.interpolate(mode="area")` is adaptive average
pooling: output cell i averages input cells [floor(i*in/out),
ceil((i+1)*in/out)). As in sdm_tpu, the map is two separable 1-D averaging
matmuls with dense fp32 weights built once per (in, out) pair, exact for
down- and up-sampling at any integer sizes. A plain matmul, so no kernel.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=64)
def _area_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) row-stochastic averaging matrix matching torch's
    adaptive_avg_pool1d."""
    w = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        start = (i * in_size) // out_size
        end = -((-(i + 1) * in_size) // out_size)  # ceil((i+1)*in/out)
        w[i, start:end] = 1.0 / (end - start)
    return w


def area_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """NHWC area resize on x's device; the result keeps x's dtype."""
    n, h, w, c = x.shape
    out = x.to(torch.float32)
    if h != out_h:
        wh = torch.from_numpy(_area_weights(h, out_h)).to(x.device)
        out = torch.einsum("oh,nhwc->nowc", wh, out)
    if w != out_w:
        ww = torch.from_numpy(_area_weights(w, out_w)).to(x.device)
        out = torch.einsum("ow,nhwc->nhoc", ww, out)
    return out.to(x.dtype)
