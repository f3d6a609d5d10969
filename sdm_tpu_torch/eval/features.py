"""Feature extractors for sample-quality metrics (port of
sdm_tpu/eval/features.py; fid.py scores their features).

Extractors take NHWC float images in [-1, 1] (what the generators return
with save_locally=False) and return an (N, D) float32 feature matrix,
computed on the device the caller names (CUDA unless "cpu").

  "pixel[:R]"     area-resize to R x R (default 8, ops/resize.py) and
                  flatten.
  "randconv[:R]"  sdm_tpu's fixed-seed random conv net: area-resize to
                  R x R (default 64), four stride-2 3x3 conv + swish stages
                  (C -> 32 -> 64 -> 128 -> 256) in bf16, then per-channel
                  mean and max pooled in fp32 (512-D). sdm_tpu draws the
                  kernels with jax.random; the port reads the same ones
                  from randconv_weights.npz (tools/torch_write_randconv.py
                  writes it from sdm_tpu's function), so the two packages'
                  scores compare. Each conv pads as XLA's "SAME" does.
  "torch:<path>"  a user's torch module (torch.jit.load or torch.load)
                  mapping NCHW [-1, 1] images to (N, D) features, e.g. a
                  local InceptionV3 head for literature-comparable FID.
"""

from __future__ import annotations

import os
from typing import Callable, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sdm_tpu_torch.ops.resize import area_resize

FeatureFn = Callable[[np.ndarray], np.ndarray]

RANDCONV_WEIGHTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "randconv_weights.npz")
_RANDCONV_STRIDE = 2


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' (--device cpu) "
                           "to extract features on the CPU")
    return dev


def _to_nhwc_batch(images: np.ndarray) -> np.ndarray:
    x = np.asarray(images, np.float32)
    if x.ndim != 4 or x.shape[-1] not in (1, 3, 6):
        raise ValueError(f"expected NHWC images, got shape {x.shape}")
    return x


def _pixel_features(images: np.ndarray, res: int,
                    dev: torch.device) -> np.ndarray:
    x = torch.from_numpy(_to_nhwc_batch(images)).to(dev)
    small = area_resize(x, res, res)
    return small.reshape(small.shape[0], -1).cpu().numpy()


def randconv_kernels(in_channels: int) -> List[np.ndarray]:
    """The four HWIO fp32 conv kernels of sdm_tpu's randconv net for
    `in_channels` (1, 3 or 6); its biases are zeros."""
    with np.load(RANDCONV_WEIGHTS) as z:
        return [z[f"w0_c{in_channels}"], z["w1"], z["w2"], z["w3"]]


def same_padding(size: int, kernel: int = 3,
                 stride: int = _RANDCONV_STRIDE) -> Tuple[int, int]:
    """XLA's "SAME" (before, after) padding of one spatial axis: the output
    is ceil(size / stride) and the extra pad goes after, so a stride-2 3x3
    conv pads an even axis by (0, 1) where Conv2d(padding=1) pads (1, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _randconv_forward(kernels: List[torch.Tensor],
                      x: torch.Tensor) -> torch.Tensor:
    """NHWC fp32 images -> (N, 512) fp32: bf16 convs and swish, fp32
    pooling, as sdm_tpu's _randconv_forward."""
    h = x.permute(0, 3, 1, 2).to(torch.bfloat16)
    for w in kernels:
        ph, pw = (same_padding(h.shape[2]), same_padding(h.shape[3]))
        h = F.conv2d(F.pad(h, (*pw, *ph)), w, stride=_RANDCONV_STRIDE)
        h = h * torch.sigmoid(h)
    h = h.to(torch.float32)
    return torch.cat([h.mean(dim=(2, 3)), h.amax(dim=(2, 3))], dim=-1)


def _randconv_features(images: np.ndarray, res: int, batch_size: int,
                       dev: torch.device) -> np.ndarray:
    x = _to_nhwc_batch(images)
    kernels = [torch.from_numpy(w).permute(3, 2, 0, 1).contiguous()
               .to(dev, torch.bfloat16)
               for w in randconv_kernels(x.shape[-1])]
    outs = []
    # A fixed batch (the last one zero-padded, trimmed after), as sdm_tpu
    # keeps one compiled program: every row sees the same conv plan.
    with torch.no_grad():
        for i in range(0, len(x), batch_size):
            chunk = x[i:i + batch_size]
            n = len(chunk)
            if n < batch_size:
                chunk = np.concatenate(
                    [chunk, np.zeros((batch_size - n,) + chunk.shape[1:],
                                     np.float32)])
            small = area_resize(torch.from_numpy(chunk).to(dev), res, res)
            outs.append(_randconv_forward(kernels, small)[:n].cpu().numpy())
    return np.concatenate(outs)


def _torch_features(images: np.ndarray, module_path: str, batch_size: int,
                    dev: torch.device) -> np.ndarray:
    try:
        net = torch.jit.load(module_path, map_location=dev)
    except (RuntimeError, ValueError):
        # A pickled nn.Module the user supplies, not a TorchScript file.
        net = torch.load(module_path, map_location=dev, weights_only=False)
    net.eval()
    x = _to_nhwc_batch(images)
    outs = []
    with torch.no_grad():
        for i in range(0, len(x), batch_size):
            chunk = torch.from_numpy(
                x[i:i + batch_size].transpose(0, 3, 1, 2)).to(dev)  # NCHW
            f = net(chunk)
            if isinstance(f, (tuple, list)):
                f = f[0]
            outs.append(f.reshape(f.shape[0], -1).float().cpu().numpy())
    return np.concatenate(outs)


def make_feature_extractor(spec: str = "randconv", batch_size: int = 64,
                           device="cuda") -> Tuple[FeatureFn, str]:
    """Build a (N,H,W,C)[-1,1] -> (N,D) extractor from a spec string,
    running on `device`. Returns (fn, canonical_name). Specs: "pixel",
    "pixel:16", "randconv", "randconv:32", "torch:/path/to/module.pt"."""
    dev = _device(device)
    if spec.startswith("torch:"):
        path = spec[len("torch:"):]
        if not path:
            raise ValueError("torch feature spec needs a path: torch:<path>")
        return (lambda imgs: _torch_features(imgs, path, batch_size, dev),
                f"torch:{path}")
    name, _, arg = spec.partition(":")
    if name == "pixel":
        res = int(arg) if arg else 8
        return (lambda imgs: _pixel_features(imgs, res, dev), f"pixel:{res}")
    if name == "randconv":
        res = int(arg) if arg else 64
        return (lambda imgs: _randconv_features(imgs, res, batch_size, dev),
                f"randconv:{res}")
    raise ValueError(
        f"unknown feature spec {spec!r} (pixel[:R], randconv[:R], "
        "torch:<path>)")
