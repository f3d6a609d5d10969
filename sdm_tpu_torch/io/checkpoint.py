"""Checkpoint save/load in the reference's formats (port of
sdm_tpu/io/checkpoint.py).

`save_model` writes torch.save files to
`{dest}/checkpoint|models/{file_name}_{steps}.pt`; `load_checkpoint` returns
`(ok, dict)`, mapped to the CPU. Model checkpoints are
`{"model": <state_dict>, "optimizer": <Adam state_dict>}`; in torch that is
the native format, so the port's state_dict goes in and out unchanged.
"""

from __future__ import annotations

import os
from typing import Any, Optional, Tuple

import torch


def save_model(model_net: Any, file_name: str, dest_path: str,
               checkpoint: bool = False, steps: int = 0, log=print) -> bool:
    """torch.save `model_net` to {dest}/checkpoint|models/{file_name}_{steps}.pt."""
    try:
        sub = "checkpoint" if checkpoint else "models"
        f_path = os.path.join(dest_path, sub)
        os.makedirs(f_path, exist_ok=True)
        torch.save(model_net, os.path.join(f_path, f"{file_name}_{steps}.pt"))
        return True
    except OSError as e:
        log(f"Exception occured while saving model: {e}.")
        return False


def load_checkpoint(checkpoint_path: str, log=print
                    ) -> Tuple[bool, Optional[dict]]:
    if os.path.exists(checkpoint_path):
        log(f"Loading checkpoint: {checkpoint_path}")
        try:
            # Tensors, dicts and scalars only: a {model, optimizer}
            # checkpoint needs nothing else, and nothing else is unpickled.
            ckpt = torch.load(checkpoint_path,
                              map_location=torch.device("cpu"),
                              weights_only=True)
            return True, ckpt
        except (OSError, RuntimeError, EOFError):
            return False, None
    log("Checkpoint does not exist.")
    return False, None
