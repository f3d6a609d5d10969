"""The port's fused device-resident training loop ("device_dataset") and
its trace option against sdm_tpu's, on test_torch_train_loop.py's tiny
U-Net and images: the fused base trainer's index blocks, log lines and
files held to sdm_tpu's, a fused chunk held to the port's own per-step
train steps, the doodle trainer fused with its conditioning images, the
NaN guard before an async or fused checkpoint, the refusal of gradient
accumulation, and "profile_trace_dir" per-step and fused.
"""

import json
import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from sdm_tpu.train import loop as jax_loop  # noqa: E402
from sdm_tpu_torch.data import ImageDataset  # noqa: E402
from sdm_tpu_torch.models import UNet  # noqa: E402
from sdm_tpu_torch.ops.schedules import make_schedule  # noqa: E402
from sdm_tpu_torch.train import loop  # noqa: E402
from sdm_tpu_torch.train.step import (  # noqa: E402
    create_train_state, make_optimizer, make_train_step)
from test_torch_train_loop import (  # noqa: E402
    _config, _log, _masked, _run_jax, _run_port, _step_wrapper, images)


# ---- the fused device-resident loop ("device_dataset") ----

FUSED = dict(device_dataset=True, steps_per_call=2)


@pytest.fixture(scope="module")
def fused_runs(images, tmp_path_factory):
    """Both packages' base trainer fused, K = 2, over 5 steps (three
    chunks: the run overshoots to 6), and sdm_tpu's index blocks as its
    fused call received them."""
    import jax
    blocks = []
    real_jit = jax.jit

    def spy_jit(fn=None, *args, **kwargs):
        if fn is None:
            return lambda f: spy_jit(f, *args, **kwargs)
        jitted = real_jit(fn, *args, **kwargs)
        if getattr(fn, "__name__", "") != "fused_fn":
            return jitted

        def call(st, data, idx, key):
            blocks.append(np.asarray(idx))
            return jitted(st, data, idx, key)
        return call

    out = {"jax_blocks": blocks}
    for pkg, run, spec in (("jax", _run_jax, jax_loop.BASE_SPEC),
                           ("port", _run_port, loop.BASE_SPEC)):
        d = str(tmp_path_factory.mktemp(f"fused_{pkg}"))
        jax.jit = spy_jit
        try:
            summary = run(spec, _config(images, d, **FUSED))
        finally:
            jax.jit = real_jit
        assert summary["global_steps"] == 6
        assert np.isfinite(summary["last_loss"])
        out[pkg] = d
    return out


def test_fused_index_blocks_match_sdm_tpu(fused_runs):
    """The port's index blocks equal the ones sdm_tpu's fused call got,
    exactly, across the epoch-permutation boundaries (6 rows, batch 2,
    K = 2: three steps an epoch, blocks that straddle two epochs)."""
    want = fused_runs["jax_blocks"]
    assert len(want) == 3
    got = loop.fused_index_blocks(0, 6, 2, 3, 2)
    for block in want:
        np.testing.assert_array_equal(next(got), block)
    more = loop.fused_index_blocks(7, 13, 4, 3, 5)
    perm = np.random.default_rng((7 + 0x9E3779B9) % 2 ** 63)
    stream = np.concatenate([perm.permutation(13)[:12] for _ in range(4)])
    for i in range(2):
        np.testing.assert_array_equal(next(more),
                                      stream[i * 20:(i + 1) * 20]
                                      .reshape(5, 4))


def test_fused_log_lines_and_files_match_sdm_tpu(fused_runs):
    """The banner, the resident dataset's line, the burst of per-step
    lines, the epoch and rate lines (losses and rates masked), and the
    checkpoint and preview files: chunk-boundary checkpoints at 2, 4 and 6
    with previews, epoch ends at 3 and 6."""
    jax_dir, port_dir = fused_runs["jax"], fused_runs["port"]
    port = _log(port_dir)
    assert _masked(port, port_dir) == _masked(_log(jax_dir), jax_dir)
    assert any(line.endswith("Device-resident dataset: 6 rows (0.0 MiB) "
                             "in device memory; 2 steps fused per call.")
               for line in port)
    for sub in ("checkpoint", "plots"):
        assert (sorted(os.listdir(os.path.join(port_dir, sub)))
                == sorted(os.listdir(os.path.join(jax_dir, sub))))
    assert sorted(os.listdir(os.path.join(port_dir, "checkpoint"))) == \
        sorted(f"{k}_{s}.pt" for k in ("config", "diffusion")
               for s in (2, 3, 4, 6))


def test_fused_chunk_equals_per_step_train_steps(images, tmp_path):
    """One fused chunk of K = 3 steps leaves the parameters that three
    calls of the port's own train step leave, given the same initial
    model, the same gathered batches (the first index block over the
    resident dataset) and a generator of the same seed: bit-identical."""
    cfg = _config(images, tmp_path / "out", device_dataset=True,
                  steps_per_call=3, seed=5)
    summary = _run_port(loop.BASE_SPEC, cfg, steps=3)
    assert summary["global_steps"] == 3

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(5)
        net = UNet.from_config(cfg, dtype=None, use_kernels=True)
    net = net.to("cpu", memory_format=torch.channels_last)
    opt, sched = make_optimizer(net.parameters(), cfg["diffusion_lr"],
                                cfg["lr_steps"])
    state = create_train_state(net, opt, sched)
    step = make_train_step(
        make_schedule("LINEAR", beta_1=5e-3, beta_T=9e-3,
                      max_noise_step=10), objective=loop.BASE_SPEC.objective,
        min_noise_step=1, max_actual_noise_step=10, flip_imgs=True)
    import glob
    data = loop.load_resident(ImageDataset(glob.glob(images),
                                           normalized=False),
                              torch.device("cpu"), False)
    gen = torch.Generator().manual_seed(5)
    block = next(loop.fused_index_blocks(5, 6, 2, 3, 3))
    for rows in torch.from_numpy(block):
        step(state, {k: v.index_select(0, rows) for k, v in data.items()},
             gen)
    fused = summary["state"].model.state_dict()
    for name, value in net.state_dict().items():
        torch.testing.assert_close(fused[name], value, rtol=0, atol=0)


def test_fused_doodle_run_carries_the_conditioning_images(images, tmp_path):
    """The doodle trainer fused: image and cond_img both resident (the
    MiB line counts both), losses finite, the same files as the base
    trainer's fused run plus the conditioning grid."""
    summary = _run_port(loop.DOODLE_SPEC, _config(images, tmp_path,
                                                  "doodle", **FUSED))
    assert summary["global_steps"] == 6
    assert np.isfinite(summary["last_loss"])
    lines = _log(str(tmp_path))
    assert any("Device-resident dataset: 6 rows" in line for line in lines)
    assert sorted(os.listdir(tmp_path / "plots")) == sorted(
        ["label_plot.jpg"] + [f"diffusion_plot_{s}.jpg" for s in (2, 4, 6)])


@pytest.mark.parametrize("extra,saved,unsaved", [
    (dict(async_checkpoint=True), "diffusion_0.pt", "diffusion_2.pt"),
    (FUSED, "diffusion_2.pt", "diffusion_4.pt")])
def test_nan_guard_fires_before_an_async_or_fused_checkpoint(
        images, tmp_path, monkeypatch, extra, saved, unsaved):
    """A NaN in the third step's loss stops the run before the next
    checkpoint is written: with async checkpoints the step-2 one (step 0's
    was saved by the worker), in the fused loop (K = 2) the step-4 one at
    the end of the NaN's chunk (the first chunk's step-2 one was saved)."""
    _step_wrapper(monkeypatch, lambda i, m: (
        {"loss": torch.tensor(float("nan"))} if i == 3 else m))
    with pytest.raises(Exception, match="NaN encountered during training"):
        _run_port(loop.BASE_SPEC, _config(images, tmp_path, **extra))
    names = os.listdir(tmp_path / "checkpoint")
    assert saved in names and unsaved not in names


def test_fused_loop_rejects_grad_accumulation(images, tmp_path):
    with pytest.raises(ValueError, match='"device_dataset" fused training '
                                         "supports single-process runs "
                                         "without sp/grad_accum_steps"):
        _run_port(loop.BASE_SPEC, _config(images, tmp_path, **FUSED,
                                          grad_accum_steps=2))


@pytest.mark.parametrize("extra", [{}, FUSED], ids=["per_step", "fused"])
def test_profile_trace_dir_writes_a_trace(images, tmp_path, extra):
    """"profile_trace_dir": a two-step run (per-step, or fused with K = 2)
    writes one Chrome trace of the loop for its rank, naming the
    U-Net's ops; the run trains as without it."""
    trace = tmp_path / "trace"
    summary = _run_port(loop.BASE_SPEC, _config(
        images, tmp_path / "out", profile_trace_dir=str(trace), **extra),
        steps=2)
    assert summary["global_steps"] == 2
    assert os.listdir(trace) == ["trace_rank0.json"]
    with open(trace / "trace_rank0.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::convolution" in names, sorted(names)[:20]
