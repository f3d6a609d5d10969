"""Native checkpoints of the whole train state on torch.distributed.checkpoint
(the port's counterpart of sdm_tpu/io/orbax_ckpt.py, config
"native_checkpoint").

The `.pt` files (io/checkpoint.py) are the interop path; this one saves
the whole train state (the parameters and buffers, Adam's moments and
counts, the EMA when tracked, the step) as each rank's own pieces, and
restores it onto the layout of the resuming run, whatever the saving run's
was: one device, DDP, FSDP2, TP, SP or a composition. Each rank reads only
the pieces it holds, so the cost follows the state per device.

Every entry goes to DCP as the tensor it is a piece of: whole tensors as
they are, FSDP2's DTensors as they are, and a tensor-parallel shard, a
plain tensor on its rank (parallel/tp.py), as a DTensor of its whole
tensor (`tp.as_global`). A run of any layout can then read any other's.
"""

from __future__ import annotations

import os
from typing import Dict

import torch


def _entries(state) -> Dict[str, tuple]:
    """{key: (the live tensor, the name of the parameter it follows or
    None)} of every state entry; Adam's state is created (zero moments)
    for a parameter it has not stepped yet."""
    net = getattr(state.model, "module", state.model)
    out, opt = {}, state.optimizer
    for name, p in net.named_parameters():
        out[f"model.{name}"] = (p.detach(), name)
        st = opt.state[p]
        if not st:
            st.update(step=torch.tensor(0.0),
                      exp_avg=torch.zeros_like(p.detach()),
                      exp_avg_sq=torch.zeros_like(p.detach()))
        out[f"optim.{name}.exp_avg"] = (st["exp_avg"], name)
        out[f"optim.{name}.exp_avg_sq"] = (st["exp_avg_sq"], name)
        out[f"optim.{name}.step"] = (st["step"], None)
        if state.ema is not None:
            out[f"ema.{name}"] = (state.ema[name], name)
    for name, b in net.named_buffers():
        out[f"model.{name}"] = (b, None)
    return out


def _global_dict(state, shards) -> tuple:
    """({key: the tensor as DCP sees it}, {key: the live tensor}), with
    "step" and "count"."""
    from sdm_tpu_torch.parallel.tp import as_global
    entries = _entries(state)
    live = {k: t for k, (t, _) in entries.items()}
    sd = {k: (t if shards is None or name is None
              else as_global(t, shards.names.get(name), shards.mesh))
          for k, (t, name) in entries.items()}
    sd["step"] = torch.tensor(int(state.step))
    sd["count"] = torch.tensor(int(state.count))
    return sd, live


def save_native(state, dest_path: str, steps: int, *, shards=None) -> str:
    """Write `state` (train/step.py's TrainState) to
    <dest_path>/checkpoint/native_<steps>/. `shards`
    (parallel/tp.py::StateShards) places a tensor-parallel state. A
    collective inside a process group: every rank calls it."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp
    path = os.path.abspath(os.path.join(dest_path, "checkpoint",
                                        f"native_{steps}"))
    os.makedirs(path, exist_ok=True)
    sd, _ = _global_dict(state, shards)
    dcp.save(sd, checkpoint_id=path, no_dist=not dist.is_initialized())
    return path


def load_native(path: str, state, *, shards=None) -> int:
    """Restore a native checkpoint directory into `state` in place, onto
    its layout (`shards` as for save_native); returns the restored step
    (state.step and state.count restored). Raises ValueError when the
    checkpoint's entries or their shapes differ from the state's. A
    collective inside a process group."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp
    sd, live = _global_dict(state, shards)
    saved = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    want = {k: tuple(v.shape) for k, v in sd.items()}
    have = {k: tuple(getattr(v, "size", ())) for k, v in saved.items()}
    if want != have:
        diff = sorted(set(want.items()) ^ set(have.items()))[:6]
        raise ValueError(f"the checkpoint's entries differ from the run's "
                         f"state (first differences: {diff})")
    dcp.load(sd, checkpoint_id=path, no_dist=not dist.is_initialized())
    with torch.no_grad():
        for key, t in live.items():
            got = sd[key]
            got = got.to_local() if hasattr(got, "to_local") else got
            if hasattr(t, "to_local"):
                t = t.to_local()
            if got.data_ptr() != t.data_ptr():
                t.copy_(got)
    state.step, state.count = int(sd["step"]), int(sd["count"])
    return state.step
