"""What every cell's run shares: the workload's files, seeds, the seeded
weights, the import check, and the result line.

A run is `run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`.
The cell's file `workloads/<cell>.json` names its configuration
(`configs/<config>.json`) and its driver (`drivers/<driver>.py`); the
metrics it reports are the entries of BENCHMARK.json at the checkout's
root that list the cell, each per-layer one read by `metrics/<name>.py`.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import math
import os
import sys
import time
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "sdm_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """`<kind>/<name>.py` under the benchmark's folder, loaded from its
    path (a metric's name may hold dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"gpubench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(workload: str, root: str = ROOT) -> dict:
    """The cell's workload file, its configuration and the metrics that
    BENCHMARK.json has it report: {"workload", "config", "end_to_end",
    "per_layer"}."""
    wl = load_json(HERE, "workloads", f"{workload}.json")
    cfg = load_json(HERE, "configs", f"{wl['config']}.json")
    bench = load_json(root, "BENCHMARK.json")

    def mine(metric):
        return workload in metric.get("workloads", [workload])

    return {"workload": wl, "config": cfg,
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}


def sub_seed(seed: int, tag: str) -> int:
    """A 62-bit seed for one use of the run's seed."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 2


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: the port's name only begins with it)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def cache_env(root: str = ROOT) -> None:
    """Kernel and compiler caches at fixed paths inside the checkout; no
    library that the port uses loads JAX."""
    cache = os.path.join(root, ".gpubench_cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def make_params(cfg: dict, seed: int, device) -> Dict[str, "object"]:
    """The configuration's weights from the seed, float32 on `device`: one
    uniform draw from a generator on the device, cut into the parameters
    and scaled to PyTorch's default init bounds; GroupNorm scales 1 and
    shifts 0."""
    import torch
    from gpubench.reference.unet import init_bounds, param_shapes
    shapes = param_shapes(cfg)
    bounds = init_bounds(shapes)
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed,
                                                              "weights"))
    flat = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    params, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        b = bounds[name]
        if b is None:
            fill = 1.0 if name.endswith("weight") else 0.0
            params[name] = torch.full(shape, fill, device=device)
        else:
            params[name] = flat[off:off + n].view(shape) * b
        off += n
    return params


def unet_kwargs(cfg: dict) -> dict:
    """The program's UNet constructor arguments of a configuration."""
    keys = ("num_resnet_blocks", "in_channel", "out_channel", "time_dim",
            "cond_dim", "num_layers", "attn_layers", "num_heads",
            "dim_per_head", "groups", "min_channel", "max_channel",
            "image_recon")
    out = {k: cfg[k] for k in keys}
    out["attn_layers"] = tuple(out["attn_layers"])
    return out


def rel_gap(a: float, b: float, floor: float) -> float:
    return abs(a - b) / max(abs(b), floor)


def leaf_gap(got: Dict[str, float], want: Dict[str, float],
             names: Optional[List[str]] = None) -> float:
    """The worst leaf's gap between two per-leaf norms, against the
    reference's norm of that leaf or of the median leaf, the larger."""
    names = list(want) if names is None else names
    vals = sorted(want[k] for k in want)
    median = vals[len(vals) // 2] if vals else 0.0
    return max((rel_gap(got[k], want[k], median) for k in names),
               default=0.0)


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile, linear between order statistics."""
    v = sorted(values)
    if not v:
        return float("nan")
    pos = (len(v) - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


class Clock:
    """Seconds since the run started (the process's first statement)."""

    def __init__(self, start: float):
        self.start = start

    def since(self) -> float:
        return time.perf_counter() - self.start


def device_info(count: int, peak_bytes: int) -> dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak_bytes)}


def check_line(checks: Dict[str, dict]) -> str:
    return "; ".join(f"{k} {v['value']!r} limit {v['limit']!r}"
                     for k, v in checks.items())


def judge(checks: Dict[str, dict]) -> bool:
    """Every compared number present and within its limit (a NaN or a
    missing number is not)."""
    return bool(checks) and all(
        v["value"] is not None and v["value"] <= v["limit"]
        for v in checks.values())
