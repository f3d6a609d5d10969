"""The one generator of the served traffic: a closed loop of clients, each
sending its next request when the last one is answered. Every request is
a function of (seed, client, k), so the run's clients and the reference
that checks them draw the same requests. Standard library and NumPy only:
the client process imports nothing else.

A mix's parameters (its workload file): `clients`, `sizes` (images per
request; each client walks through shuffled blocks of them, so every seed
sends the same sizes in another order), `lr_size` (the edge of a
per-request low-resolution image for the cascade's SR stage, or null) and
`keep_share` (the share of requests whose images the client keeps for the
check).
"""

from __future__ import annotations

import base64

import numpy as np


def _rng(seed: int, client: int, k: int, tag: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), client, k, tag])


def request(mix: dict, seed: int, client: int, k: int) -> dict:
    """Client `client`'s k-th request: {"num_images", "seed" (the
    request's noise seed), "keep"}."""
    sizes = list(mix["sizes"])
    block = _rng(seed, client, k // len(sizes), 0).permutation(sizes)
    rng = _rng(seed, client, k, 1)
    return {"num_images": int(block[k % len(sizes)]),
            "seed": int(rng.integers(0, 2 ** 31 - 1)),
            "keep": bool(rng.random() < mix["keep_share"])}


def lr_image(mix: dict, seed: int, client: int, k: int) -> np.ndarray:
    """The request's low-resolution image, (lr_size, lr_size, 3) float32 in
    [-1, 1]: blocks of 8x8 pixels of random colour with a little noise
    (an image with edges and flat regions, BGR like the framework's)."""
    size = mix["lr_size"]
    rng = _rng(seed, client, k, 2)
    coarse = rng.uniform(-0.9, 0.9, (size // 8, size // 8, 3))
    img = np.kron(coarse, np.ones((8, 8, 1))) + rng.normal(0, 0.05,
                                                           (size, size, 3))
    return np.clip(img, -1.0, 1.0).astype(np.float32)


def payload(mix: dict, seed: int, client: int, k: int) -> dict:
    """The JSON body of the request."""
    req = request(mix, seed, client, k)
    body = {"num_images": req["num_images"], "seed": req["seed"],
            "format": "npy"}
    if mix.get("lr_size"):
        lr = lr_image(mix, seed, client, k)
        body["lr_image_b64"] = base64.b64encode(lr.tobytes()).decode()
        body["lr_shape"] = list(lr.shape)
    return body
