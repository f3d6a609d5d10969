"""Checkpoint save/load in the reference's formats (port of
sdm_tpu/io/checkpoint.py).

`save_model` writes torch.save files to
`{dest}/checkpoint|models/{file_name}_{steps}.pt`; `load_checkpoint` returns
`(ok, dict)`, mapped to the CPU. Model checkpoints are
`{"model": <state_dict>, "optimizer": <Adam state_dict>}`; in torch that is
the native format, so the port's state_dict goes in and out unchanged.

A run with "ema_decay" also stores its EMA weights under "ema", in the
same names as "model" (sdm_tpu/io/checkpoint.py:59-73); the reference's
loader reads only "model" and "optimizer".

The optimizer entry is what sdm_tpu writes (torch_interop.py::
optax_adam_to_torch, :215-249): every parameter indexed in
`UNet.parameters()` order, which is sdm_tpu's `torch_param_order`
(tests/test_torch_train_step.py holds the two equal), one Adam step count
for all, betas (0.5, 0.999) and the run's lr in `param_groups`. So either
package resumes from the other's checkpoints, Adam moments included.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

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


def _fp32_copy(t: torch.Tensor, device) -> torch.Tensor:
    return t.detach().to(device or t.device, torch.float32, copy=True)


def diffusion_checkpoint_dict(model: torch.nn.Module, optimizer=None,
                              lr: float = 0.0,
                              ema: Optional[Dict[str, torch.Tensor]] = None,
                              device="cpu") -> Dict[str, Any]:
    """{"model": fp32 state_dict[, "optimizer": Adam state_dict][, "ema":
    the EMA weights by parameter name]}, every tensor a copy on `device`
    (None: where it lies, a snapshot that later in-place updates do not
    reach; `to_cpu` it before saving). Every parameter gets an optimizer
    entry with the run's one step count (zero moments where Adam never
    ran), and param_groups[0]["lr"] = lr."""
    out = {"model": {k: _fp32_copy(v, device)
                     for k, v in model.state_dict().items()}}
    if ema is not None:
        out["ema"] = {k: _fp32_copy(v, device) for k, v in ema.items()}
    if optimizer is None:
        return out
    sd = optimizer.state_dict()
    params = [p for g in optimizer.param_groups for p in g["params"]]
    out["optimizer"] = optimizer_entry(sd["state"], sd["param_groups"],
                                       params, lr, device)
    return out


def optimizer_entry(state: dict, param_groups: list, params: list,
                    lr: float, device) -> Dict[str, Any]:
    """The checkpoint's "optimizer" entry from Adam's state_dict() parts
    (`state` keyed by parameter index): an entry for every parameter of
    `params` with the one step count (zero moments where Adam never ran,
    shaped as that parameter), copies on `device`, and lr in
    param_groups[0]."""
    steps = [float(st["step"]) for st in state.values()]
    count = max(steps) if steps else 0.0
    entries = {}
    for idx, p in enumerate(params):
        st = state.get(idx)
        entries[idx] = {
            "step": torch.tensor(count),
            "exp_avg": _fp32_copy(st["exp_avg"] if st
                                  else torch.zeros_like(p), device),
            "exp_avg_sq": _fp32_copy(st["exp_avg_sq"] if st
                                     else torch.zeros_like(p), device)}
    groups = [dict(g) for g in param_groups]
    groups[0]["lr"] = float(lr)
    return {"state": entries, "param_groups": groups}


def to_cpu(tree):
    """`tree` (dicts and lists of tensors and scalars) with every tensor
    on the CPU."""
    if torch.is_tensor(tree):
        return tree.cpu()
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_cpu(v) for v in tree]
    return tree


def load_params_from_checkpoint(ckpt: dict, model: torch.nn.Module,
                                log=print, key: str = "model") -> None:
    """The reference's custom_load_state_dict: a partial load into `model`
    that skips keys the model lacks and keys whose shape differs, keeping
    the model's own values there (sdm_tpu's merge_partial_params)."""
    model.load_state_dict(_merge_partial(model.state_dict(), ckpt[key], log),
                          strict=True)


def load_ema_from_checkpoint(ckpt: dict, ema: Dict[str, torch.Tensor],
                             log=print) -> None:
    """The checkpoint's "ema" weights into a state's `ema` in place, with
    load_params_from_checkpoint's skip rules."""
    merged = _merge_partial(dict(ema), ckpt["ema"], log)
    with torch.no_grad():
        for name, value in merged.items():
            target = ema[name]
            if hasattr(target, "device_mesh"):
                # A sharded run's EMA (parallel/fsdp.py): this rank's shard.
                from torch.distributed.tensor import distribute_tensor
                value = distribute_tensor(value.to(target.device),
                                          target.device_mesh,
                                          target.placements)
            target.copy_(value)


def _merge_partial(own: dict, loaded: dict, log) -> dict:
    """`own` with the entries of `loaded` whose name and shape it has."""
    for name, value in loaded.items():
        if name not in own:
            log(f"No Layer found: {name}, skipping")
            continue
        if tuple(own[name].shape) != tuple(value.shape):
            log(f"Skipped: {name}")
            continue
        own[name] = value
    return own


def load_optimizer_from_checkpoint(ckpt: dict, optimizer) -> int:
    """Load the checkpoint's Adam state (moments and step counts) into
    `optimizer`; returns the step count, which the lr schedule's count
    takes (sdm_tpu's torch_adam_to_optax sets every optax count to it)."""
    sd = ckpt["optimizer"]
    state = {int(k): v for k, v in sd["state"].items()}
    optimizer.load_state_dict({"state": state,
                               "param_groups": sd["param_groups"]})
    steps = [int(float(st["step"])) for st in state.values()]
    return steps[-1] if steps else 0
