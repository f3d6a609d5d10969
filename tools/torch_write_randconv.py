#!/usr/bin/env python3
"""Write sdm_tpu's fixed-seed randconv feature weights for the PyTorch port.

    JAX_PLATFORMS=cpu python3 tools/torch_write_randconv.py [out.npz]

sdm_tpu draws its "randconv" extractor's conv kernels with jax.random from
a fixed key (sdm_tpu/eval/features.py::_randconv_params). The port imports
no JAX, so it reads the same kernels from
sdm_tpu_torch/eval/randconv_weights.npz (the default output), which this
script writes from sdm_tpu's own function. Only the first conv depends on
the input channels: the key chain and the later shapes do not, so the file
holds the first kernel for 1, 3 and 6 channels (`w0_c1`, `w0_c3`, `w0_c6`)
and the three shared ones (`w1`, `w2`, `w3`), all HWIO fp32. The biases
are zeros and are not stored.
"""

from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
CHANNELS = (1, 3, 6)
DEFAULT_OUT = os.path.join(REPO, "sdm_tpu_torch", "eval",
                           "randconv_weights.npz")


def randconv_arrays() -> dict:
    """{name: HWIO fp32 kernel} from sdm_tpu's _randconv_params."""
    from sdm_tpu.eval.features import _randconv_params
    out = {}
    shared = None
    for c in CHANNELS:
        params = _randconv_params(c)
        if any(np.asarray(b).any() for _, b in params):
            raise AssertionError("sdm_tpu's randconv biases are not zero")
        kernels = [np.asarray(w, np.float32) for w, _ in params]
        out[f"w0_c{c}"] = kernels[0]
        if shared is None:
            shared = kernels[1:]
        elif any(not np.array_equal(a, b) for a, b in zip(shared,
                                                          kernels[1:])):
            raise AssertionError("randconv layers 2-4 differ between input "
                                 "channel counts")
    out.update({f"w{i + 1}": w for i, w in enumerate(shared)})
    return out


def main(argv) -> int:
    path = os.path.abspath(argv[0] if argv else DEFAULT_OUT)
    arrays = randconv_arrays()
    np.savez(path, **arrays)
    n = sum(a.size for a in arrays.values())
    print(f"wrote {path}: {n:,} fp32 values "
          + ", ".join(f"{k} {tuple(v.shape)}" for k, v in arrays.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
