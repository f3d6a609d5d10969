"""Sample-grid plotting with the reference's exact pixel pipeline (the
port's own copy of sdm_tpu/io/plotting.py, which it does not import).

Parity with the reference's utils/utils.py:39-65: BGR->RGB channel permute
[2,1,0] (images were cv2-loaded, i.e. BGR), torchvision-make_grid-equivalent
tiling (nrow=5, padding=2, pad_value=0), normalization from value_range
(-1,1) to [0,1], then save as {dest}/plots/{name}.jpg. Implemented with
numpy + cv2 (no torchvision); cv2 is imported only to write the file.
"""

from __future__ import annotations

import os

import numpy as np


def make_grid(imgs: np.ndarray, nrow: int = 5, padding: int = 2,
              value_range=(-1.0, 1.0)) -> np.ndarray:
    """imgs: (N,H,W,C) float; returns (H',W',C) float in [0,1]
    (torchvision.utils.make_grid(normalize=True, value_range) equivalent)."""
    lo, hi = value_range
    x = np.clip((imgs.astype(np.float32) - lo) / max(hi - lo, 1e-5), 0.0, 1.0)
    n, h, w, c = x.shape
    ncol = min(nrow, n)
    nrows = int(np.ceil(n / ncol))
    grid_h = nrows * h + padding * (nrows + 1)
    grid_w = ncol * w + padding * (ncol + 1)
    grid = np.zeros((grid_h, grid_w, c), dtype=np.float32)
    for i in range(n):
        r, col = divmod(i, ncol)
        y0 = padding + r * (h + padding)
        x0 = padding + col * (w + padding)
        grid[y0:y0 + h, x0:x0 + w] = x[i]
    return grid


def plot_sampled_images(sampled_imgs, file_name: str, dest_path=None, log=print):
    """sampled_imgs: (N,H,W,C) in [-1,1], BGR channel order (cv2 pipeline)."""
    import cv2

    imgs = np.asarray(sampled_imgs)
    imgs = imgs[..., ::-1]  # BGR -> RGB (utils/utils.py:41-42)
    grid = make_grid(imgs, nrow=5, padding=2, value_range=(-1, 1))

    if dest_path is None:
        dir_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "plots")
    else:
        dir_path = os.path.join(dest_path, "plots")
    os.makedirs(dir_path, exist_ok=True)
    try:
        path = os.path.join(dir_path, str(file_name) + ".jpg")
        # save_image quantization: mul 255, add 0.5, clamp, to uint8.
        out = np.clip(grid * 255.0 + 0.5, 0, 255).astype(np.uint8)
        cv2.imwrite(path, out[..., ::-1])  # cv2 expects BGR
        log(f"Saving generated image: {path}")
        return path
    except Exception as e:
        log(f"An error occured while plotting reconstructed image: {e}")
        return None
