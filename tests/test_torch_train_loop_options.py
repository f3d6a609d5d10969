"""The port's trainer options and own semantics against sdm_tpu's and
against runs without them, on test_torch_train_loop.py's tiny U-Net and
images: determinism given "seed", the NaN guard, preemption,
"epoch_checkpoint_every", previews that fail, each of the step's
extension keys in both packages (with EMA checkpoints loaded across), the
CLI's devices, "async_checkpoint" and "remat" writing the files of a
run without them, an async snapshot that a later step leaves alone, and a
native resume bit for bit like the .pt + config resume.
"""

import json
import os
import signal

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from sdm_tpu.train import loop as jax_loop  # noqa: E402
from sdm_tpu_torch.cli import train_diffusion  # noqa: E402
from sdm_tpu_torch.io.checkpoint import (  # noqa: E402
    diffusion_checkpoint_dict, load_ema_from_checkpoint)
from sdm_tpu_torch.models import UNet  # noqa: E402
from sdm_tpu_torch.ops.schedules import make_schedule  # noqa: E402
from sdm_tpu_torch.train import loop  # noqa: E402
from sdm_tpu_torch.train.step import (  # noqa: E402
    create_train_state, make_train_step)
from test_torch_train_loop import (  # noqa: E402
    STEPS, _config, _fresh, _log, _masked, _run_jax, _run_port,
    _step_wrapper, images)


def test_seed_makes_the_run_deterministic(images, tmp_path):
    def losses_and_params(sub, seed):
        cfg = _config(images, tmp_path / sub, seed=seed)
        summary = _run_port(loop.BASE_SPEC, cfg, steps=3)
        losses = [line.split("Diffusion: ")[1]
                  for line in _log(str(tmp_path / sub))
                  if "Cum. Steps:" in line]
        return losses, [p.detach().clone()
                        for p in summary["state"].model.parameters()]

    a, b, c = (losses_and_params(s, seed) for s, seed in
               (("a", 7), ("b", 7), ("c", 8)))
    assert a[0] == b[0]
    for pa, pb in zip(a[1], b[1]):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
    assert a[0] != c[0]


def test_nan_guard_fires_before_the_checkpoint(images, tmp_path,
                                               monkeypatch):
    _step_wrapper(monkeypatch, lambda i, m: (
        {"loss": torch.tensor(float("nan"))} if i == 3 else m))
    with pytest.raises(Exception, match="NaN encountered during training"):
        _run_port(loop.BASE_SPEC, _config(images, tmp_path))
    names = os.listdir(tmp_path / "checkpoint")
    assert "diffusion_0.pt" in names and "diffusion_2.pt" not in names


def test_preemption_checkpoints_and_returns(images, tmp_path, monkeypatch):
    def hook(i, metrics):
        if i == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return metrics
    _step_wrapper(monkeypatch, hook)
    summary = _run_port(loop.BASE_SPEC, _config(images, tmp_path))
    assert summary["preempted"] and summary["global_steps"] == 2
    names = os.listdir(tmp_path / "checkpoint")
    assert "diffusion_2.pt" in names and "diffusion_3.pt" not in names
    assert any("Preempted: checkpointed at step 2; exiting." in line
               for line in _log(str(tmp_path)))
    assert signal.getsignal(signal.SIGTERM) is not None


def test_epoch_checkpoint_every_skips_epoch_ends(images, tmp_path):
    _run_port(loop.BASE_SPEC, _config(images, tmp_path, max_epoch=3,
                                      epoch_checkpoint_every=2,
                                      checkpoint_steps=100), steps=None)
    names = sorted(os.listdir(tmp_path / "checkpoint"))
    # Step 0, then the ends of epochs 2 (step 6) and 3 (step 9, the last).
    assert names == sorted(f"{kind}_{s}.pt" for kind in ("config",
                                                         "diffusion")
                           for s in (0, 6, 9))


def test_a_failing_preview_does_not_stop_training(images, tmp_path,
                                                  monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("sampler broke")
    monkeypatch.setattr(loop, "ddim_sample", broken)
    summary = _run_port(loop.BASE_SPEC, _config(images, tmp_path), steps=3)
    assert summary["global_steps"] == 3
    assert any("Preview sampling failed: sampler broke" in line
               for line in _log(str(tmp_path)))
    assert not os.path.exists(tmp_path / "plots")


@pytest.mark.parametrize("key,value", [
    ("grad_accum_steps", 2), ("cfg_drop_prob", 0.1), ("ema_decay", 0.999),
    ("min_snr_gamma", 5.0), ("objective", "V")])
def test_extension_config_keys_match_sdm_tpu(images, tmp_path, key, value):
    """The base trainer with each of the step's extensions, in both
    packages: the same log lines, checkpoint and preview files and
    checkpoint keys ("ema" beside "model" under ema_decay), finite losses.
    An EMA checkpoint of either package loads into the other's EMA with
    every key."""
    dirs = {}
    for pkg, run, spec in (("jax", _run_jax, jax_loop.BASE_SPEC),
                           ("port", _run_port, loop.BASE_SPEC)):
        dirs[pkg] = str(tmp_path / pkg)
        summary = run(spec, _config(images, dirs[pkg], **{key: value}),
                      steps=3)
        assert summary["global_steps"] == 3
        assert np.isfinite(summary["last_loss"])
    port = _log(dirs["port"])
    assert _masked(port, dirs["port"]) == _masked(_log(dirs["jax"]),
                                                  dirs["jax"])
    for sub in ("checkpoint", "plots"):
        assert (sorted(os.listdir(os.path.join(dirs["port"], sub)))
                == sorted(os.listdir(os.path.join(dirs["jax"], sub))))
    ck_j, ck_t = (torch.load(os.path.join(d, "checkpoint", "diffusion_2.pt"))
                  for d in (dirs["jax"], dirs["port"]))
    want = {"model", "optimizer"} | ({"ema"} if key == "ema_decay"
                                     else set())
    assert set(ck_t) == set(ck_j) == want
    if key != "ema_decay":
        return
    from sdm_tpu.io.checkpoint import \
        load_params_from_checkpoint as jax_load_params
    from sdm_tpu.io.torch_interop import (params_to_torch_state_dict,
                                          torch_state_dict_to_params)
    assert list(ck_t["ema"]) == list(ck_t["model"])
    assert set(ck_t["ema"]) == set(ck_j["ema"])
    net = UNet.from_config(_config(images, tmp_path))
    ema = {name: p.detach().clone() for name, p in net.named_parameters()}
    load_ema_from_checkpoint(ck_j, ema, log=pytest.fail)
    for name, value in ck_j["ema"].items():
        torch.testing.assert_close(ema[name], value, rtol=0, atol=0)
    loaded = params_to_torch_state_dict(jax_load_params(
        ck_t, torch_state_dict_to_params(ck_j["ema"]), log=pytest.fail,
        key="ema"))
    for name, value in ck_t["ema"].items():
        np.testing.assert_array_equal(loaded[name].numpy(), value.numpy())


def test_cli_runs_on_the_cpu_and_defaults_to_cuda(images, tmp_path):
    assert loop.parse_args(loop.BASE_SPEC, ["-c", "x.json"])["device"] == \
        "cuda"
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(_config(images, tmp_path / "out")))
    summary = train_diffusion.run(["-c", str(path), "--device", "cpu",
                                   "--steps", "2"])
    assert summary["global_steps"] == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_diffusion.run(["-c", str(path), "--steps", "1"])


# ---- "async_checkpoint" and "remat" in the trainer ----

def _checkpoints(out_dir):
    d = os.path.join(out_dir, "checkpoint")
    return {name: torch.load(os.path.join(d, name))
            for name in sorted(os.listdir(d))}


def _assert_same_tree(a, b, where=""):
    if torch.is_tensor(a):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=where)
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_same_tree(a[k], b[k], f"{where}/{k}")
    else:
        assert a == b, where


@pytest.mark.parametrize("key", ["async_checkpoint", "remat"])
def test_async_checkpoint_and_remat_write_the_sync_run_files(images,
                                                             tmp_path, key):
    """With the same seed, a run with "async_checkpoint" (the worker
    thread saves and previews a device snapshot) or "remat" writes the
    same checkpoint files as a run without it, every tensor bit-identical
    (parameters, Adam moments and counts, lr), and the same previews; the
    log lines match (rates masked)."""
    dirs = {}
    for name, extra in (("plain", {}), (key, {key: True})):
        dirs[name] = str(tmp_path / name)
        summary = _run_port(loop.BASE_SPEC, _config(images, dirs[name],
                                                    ema_decay=0.9, **extra))
        assert summary["global_steps"] == STEPS
    want, got = _checkpoints(dirs["plain"]), _checkpoints(dirs[key])
    assert list(got) == list(want)
    for name in want:
        _assert_same_tree(got[name], want[name], name)
    assert (sorted(os.listdir(os.path.join(dirs[key], "plots")))
            == sorted(os.listdir(os.path.join(dirs["plain"], "plots"))))
    got, want = (_masked(_log(dirs[k]), dirs[k]) for k in (key, "plain"))
    previews = [[line for line in lines if "Saving generated image" in line]
                for lines in (got, want)]
    assert sorted(previews[0]) == sorted(previews[1]) != []
    if key == "async_checkpoint":
        got, want = ([line for line in lines
                      if "Saving generated image" not in line]
                     for lines in (got, want))
    assert got == want


def test_async_snapshot_survives_a_later_in_place_step(images):
    """diffusion_checkpoint_dict(device=None), the async snapshot, copies
    the parameters, Adam moments and EMA: a later in-place Adam step moves
    the live tensors but not the snapshot."""
    cfg = _config(images, "unused")
    net, opt = _fresh(cfg)
    state = create_train_state(net, opt, lambda c: 1e-2, ema=True)
    step = make_train_step(make_schedule("LINEAR", max_noise_step=10),
                           objective=loop.BASE_SPEC.objective,
                           max_actual_noise_step=10, ema_decay=0.5)
    batch = {"image": torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 8, 8, 3), dtype=np.uint8))}
    step(state, batch, torch.Generator().manual_seed(0))
    snap = diffusion_checkpoint_dict(net, opt, lr=1e-2, ema=state.ema,
                                     device=None)
    frozen = diffusion_checkpoint_dict(net, opt, lr=1e-2, ema=state.ema)
    step(state, batch, torch.Generator().manual_seed(1))
    _assert_same_tree(loop.to_cpu(snap), frozen)
    moved = diffusion_checkpoint_dict(net, opt, lr=1e-2, ema=state.ema)
    assert not torch.equal(moved["model"]["out_layers.1.conv_layer.0.bias"],
                           snap["model"]["out_layers.1.conv_layer.0.bias"])
    assert not torch.equal(moved["optimizer"]["state"][0]["exp_avg"],
                           snap["optimizer"]["state"][0]["exp_avg"])


def test_native_resume_equals_the_pt_resume(images, tmp_path):
    """A model_checkpoint that is a native directory restores the whole
    state (parameters, Adam, EMA, the step; no config checkpoint, no
    load_diffusion_optim) and continues bit for bit like the .pt + config
    resume (sdm_tpu's tests/test_train_loop.py:296)."""
    out = tmp_path / "out"
    _run_port(loop.BASE_SPEC, _config(images, out, native_checkpoint=True,
                                      ema_decay=0.999), steps=2)
    ckpt = out / "checkpoint"
    runs = {}
    for name, over in (
            ("pt", dict(model_checkpoint=str(ckpt / "diffusion_2.pt"),
                        config_checkpoint=str(ckpt / "config_2.pt"),
                        load_diffusion_optim=True)),
            ("native", dict(model_checkpoint=str(ckpt / "native_2")))):
        runs[name] = _run_port(loop.BASE_SPEC, _config(
            images, tmp_path / name, ema_decay=0.999, **over), steps=4)
        assert runs[name]["global_steps"] == 4
    a, b = runs["pt"]["state"], runs["native"]["state"]
    _assert_same_tree(a.model.state_dict(), b.model.state_dict())
    _assert_same_tree(a.ema, b.ema)
    _assert_same_tree(a.optimizer.state_dict()["state"],
                      b.optimizer.state_dict()["state"])
    assert any("Restored native checkpoint" in line and "step 2" in line
               for line in _log(str(tmp_path / "native")))


def test_native_resume_mismatch_names_ema_and_model_config(images,
                                                           tmp_path):
    _run_port(loop.BASE_SPEC, _config(images, tmp_path / "out",
                                      native_checkpoint=True), steps=1)
    with pytest.raises(Exception, match='"ema_decay" on/off setting and '
                                        "model config must match"):
        _run_port(loop.BASE_SPEC, _config(
            images, tmp_path / "resume", ema_decay=0.999,
            model_checkpoint=str(tmp_path / "out" / "checkpoint"
                                 / "native_0")), steps=2)
