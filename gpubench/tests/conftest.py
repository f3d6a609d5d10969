"""Shared pieces of the benchmark's CPU tests: the repository root on the
path, and a cell's spec shrunk to a size the CPU runs in seconds."""

import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = dict(min_channel=32, max_channel=64, num_layers=2, attn_layers=[1],
            time_dim=32, image_size=16)


def tiny_spec(name: str) -> dict:
    """The cell's spec at TINY widths: 3 clients, every answer kept, 4
    images checked; a training batch of 4."""
    from gpubench import harness
    spec = harness.cell_spec(name)
    cfg = dict(spec["config"], **TINY)
    if cfg.get("lr_dim"):
        cfg["lr_dim"] = 8
    wl = dict(spec["workload"])
    if "mix" in wl:
        mix = dict(wl["mix"], clients=3, keep_share=1.0)
        if mix.get("lr_size"):
            mix["lr_size"] = 8
        wl.update(mix=mix, max_batch=8, check_images=4)
    else:
        wl.update(batch=4, distinct_batches=4, ref_rows=2)
    return dict(spec, config=cfg, workload=wl)


def cpu_run(spec: dict, seed: int, fault=None, seconds: float = 2.0):
    """One run of the cell's driver on the CPU, with `fault` planted."""
    import torch
    from gpubench import harness
    driver = harness.load_module("drivers", spec["workload"]["driver"])
    return driver.run({"spec": spec, "seed": seed, "seconds": seconds,
                       "trace": False, "device": torch.device("cpu"),
                       "clock": harness.Clock(time.perf_counter()),
                       "fault": fault})


@pytest.fixture
def tiny():
    return tiny_spec
