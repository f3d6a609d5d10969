"""Carry sdm_tpu's weights across: flax param tree -> the port's state_dict.

The port's own copy of the mapping in sdm_tpu/io/torch_interop.py:44-135
(it imports nothing of sdm_tpu). sdm_tpu named its flax modules after the
torch attribute paths with Sequential/ModuleList indices folded in, so flax
("down_layers_0", "res_layers_1", "conv_block_1", "conv_layer_0", "kernel")
is torch "down_layers.0.res_layers.1.conv_block_1.conv_layer.0.weight".

Layouts:
  - Conv2d kernel HWIO (kh, kw, in, out)   -> (out, in, kh, kw)
  - ConvTranspose2d kernel (kh, kw, in, out) -> (in, out, kh, kw)
  - Linear kernel (in, out)                -> (out, in)
  - GroupNorm scale / bias                 -> weight / bias
"""

from __future__ import annotations

import re
from typing import Any, Dict, Tuple

import numpy as np
import torch

_SEQ_CONTAINERS = frozenset({
    "in_layer", "down_layers", "middle_layer", "up_layers", "out_layers",
    "res_layers", "attn_layers", "conv_layer", "time_layer", "cond_layer",
})
_SEQ_RE = re.compile(
    r"^(" + "|".join(sorted(_SEQ_CONTAINERS)) + r")_(\d+)$")


def _flax_component_to_torch(comp: str) -> Tuple[str, ...]:
    m = _SEQ_RE.match(comp)
    return (m.group(1), m.group(2)) if m else (comp,)


def _is_conv_transpose(flax_path: Tuple[str, ...]) -> bool:
    # The only ConvTranspose2d lives at up_layers_*.out_layer.conv_layer_0
    # (UpsampleBlock).
    return (len(flax_path) >= 3
            and flax_path[-3].startswith("up_layers")
            and flax_path[-2] == "out_layer"
            and flax_path[-1] == "conv_layer_0")


def _flatten(tree, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    flat: Dict[Tuple[str, ...], Any] = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            flat.update(_flatten(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = v
    return flat


def params_to_state_dict(np_params) -> Dict[str, torch.Tensor]:
    """sdm_tpu flax params (nested dict of numpy arrays) -> a state_dict
    for `sdm_tpu_torch.models.UNet.load_state_dict(strict=True)`. Values
    are fp32 copies."""
    state_dict: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(np_params).items():
        arr = np.asarray(arr, dtype=np.float32)
        *module_parts, leaf = path
        torch_parts: list = []
        for comp in module_parts:
            torch_parts.extend(_flax_component_to_torch(comp))
        if leaf == "kernel":
            if arr.ndim == 4:
                arr = (arr.transpose(2, 3, 0, 1)
                       if _is_conv_transpose(tuple(module_parts))
                       else arr.transpose(3, 2, 0, 1))
            elif arr.ndim == 2:
                arr = arr.transpose(1, 0)
            torch_leaf = "weight"
        elif leaf == "scale":
            torch_leaf = "weight"
        elif leaf == "bias":
            torch_leaf = "bias"
        else:
            raise ValueError(f"Unexpected flax leaf {path!r}")
        key = ".".join(torch_parts + [torch_leaf])
        state_dict[key] = torch.from_numpy(np.array(arr, copy=True))
    return state_dict
