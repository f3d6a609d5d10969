"""The port's trainers (sdm_tpu_torch/train/loop.py: BASE_SPEC, SR_SPEC,
COLD_SPEC and DOODLE_SPEC) against sdm_tpu's, on a tiny U-Net and six
cv2-written 8x8 images (paired, for the doodle trainer, with six 8x8
conditioning images through a TinyDB file).

The two packages draw their noise from different generators, so the losses
differ; everything else is held equal: the log lines (timestamps, paths and
loss values masked), the checkpoint and preview file names, and the
checkpoints' contents. A checkpoint of either package resumes in the other,
strictly, with its Adam moments and step count. Both packages draw the
doodle preview batch unseeded, so its preview and label_plot grids are held
by name and shape, as every trainer's are, never by pixels. Both packages
decode natively (their loaders' default). The port's own semantics are
checked beside: resume LR, determinism given "seed", the NaN guard,
preemption, "epoch_checkpoint_every" and previews that fail. The fused
device-resident loop ("device_dataset") is held to sdm_tpu's by its index
blocks, log lines and files, and to the port's own per-step train step;
"async_checkpoint" and "remat" write the same files as a run without them.
The base trainers of both packages write native checkpoints
("native_checkpoint"), under the same names; a native resume continues
bit for bit like the .pt + config resume; "profile_trace_dir" writes a
trace per run, per-step or fused.
"""

import json
import os
import re
import signal

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from sdm_tpu.train import loop as jax_loop  # noqa: E402
from sdm_tpu.train.step import resume_lr_schedule  # noqa: E402
from sdm_tpu_torch.cli import train_diffusion  # noqa: E402
from sdm_tpu_torch.data.tinydb_compat import write_tables  # noqa: E402
from sdm_tpu_torch.io.checkpoint import (  # noqa: E402
    load_checkpoint, load_ema_from_checkpoint, load_optimizer_from_checkpoint)
from sdm_tpu_torch.data import ImageDataset  # noqa: E402
from sdm_tpu_torch.io.checkpoint import diffusion_checkpoint_dict  # noqa: E402
from sdm_tpu_torch.models import UNet  # noqa: E402
from sdm_tpu_torch.ops.schedules import make_schedule  # noqa: E402
from sdm_tpu_torch.train import loop  # noqa: E402
from sdm_tpu_torch.train.step import (  # noqa: E402
    create_train_state, make_optimizer, make_train_step)

STEPS = 5          # two epochs of three batches, checkpoints every 2 steps
SPECS = {"base": (jax_loop.BASE_SPEC, loop.BASE_SPEC),
         "sr": (jax_loop.SR_SPEC, loop.SR_SPEC),
         "cold": (jax_loop.COLD_SPEC, loop.COLD_SPEC),
         "doodle": (jax_loop.DOODLE_SPEC, loop.DOODLE_SPEC)}


def _config(img_glob, out_dir, trainer="base", **over):
    """A tiny config for `trainer`; the doodle trainer reads the TinyDB
    file that the `images` fixture writes beside the images."""
    cfg = dict(dataset_path=img_glob, use_conditional=False, cond_dim=None,
               out_dir=str(out_dir), checkpoint_steps=2, lr_steps=100,
               max_epoch=2, plot_img_count=4, flip_imgs=True,
               model_checkpoint=None, load_diffusion_optim=False,
               config_checkpoint=None, diffusion_lr=1e-4, batch_size=2,
               noise_scheduler="LINEAR", beta1=5e-3, betaT=9e-3,
               diffusion_alg="DDIM", skip_step=5, min_noise_step=1,
               max_noise_step=10, max_actual_noise_step=10, in_channel=3,
               out_channel=3, num_layers=1, num_resnet_block=1,
               attn_layers=[0], attn_heads=1, attn_dim_per_head=None,
               time_dim=8, min_channel=32, max_channel=32, img_recon=False,
               compute_dtype="float32")
    if trainer == "sr":
        cfg.update(in_channel=6, img_recon=True, lr_dim=4, sr_dim=8,
                   cond_t=5)
    elif trainer == "cold":
        cfg.update(diffusion_alg="COLD", img_recon=True)
    elif trainer == "doodle":
        # The doodle wizard's keys: no flip_imgs.
        del cfg["flip_imgs"]
        cfg.update(dataset_path=os.path.join(os.path.dirname(img_glob),
                                             "doodle.json"), in_channel=6)
    cfg.update(over)
    return cfg


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    rows = []
    for i in range(6):
        for kind in ("im", "doodle"):
            cv2.imwrite(str(d / f"{kind}_{i}.png"),
                        rng.integers(0, 256, (8, 8, 3), dtype=np.uint8))
        rows.append({"filename": str(d / f"im_{i}.png"),
                     "doodle": str(d / f"doodle_{i}.png")})
    write_tables(str(d / "doodle.json"),
                 {"Data": rows, "Labels": [{"labels": ["doodle"]}]})
    return str(d / "im_*.png")


def _run_port(spec, cfg, steps=STEPS):
    return loop.run_training(spec, cfg, device="cpu", max_steps=steps)


def _run_jax(spec, cfg, steps=STEPS):
    return jax_loop.run_training(spec, cfg, num_devices=1, max_steps=steps)


@pytest.fixture(scope="module")
def runs(images, tmp_path_factory):
    """{(package, trainer): out_dir} after STEPS steps of each trainer."""
    out = {}
    for name, (spec_j, spec_t) in SPECS.items():
        for pkg, run, spec in (("jax", _run_jax, spec_j),
                               ("port", _run_port, spec_t)):
            d = tmp_path_factory.mktemp(f"{pkg}_{name}")
            summary = run(spec, _config(images, d, name,
                                        native_checkpoint=name == "base"))
            assert summary["global_steps"] == STEPS
            assert np.isfinite(summary["last_loss"])
            out[(pkg, name)] = str(d)
    return out


def _log(out_dir):
    (name,) = [f for f in os.listdir(out_dir) if f.endswith(".log")]
    with open(os.path.join(out_dir, name)) as f:
        return f.read().splitlines()


def _masked(lines, out_dir):
    """Log lines without the timestamp, the output path, loss values,
    rates and the compute dtype's framework name, and without asyncio's
    "Using selector" lines (sdm_tpu's orbax saves log them)."""
    out = []
    for line in lines:
        line = re.sub(r"^\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d+ ", "", line)
        if line.startswith("Using selector: "):
            continue
        line = line.replace(out_dir, "<out>")
        line = re.sub(r"Diffusion: [0-9.]+", "Diffusion: <loss>", line)
        line = re.sub(r"^Rate: .*", "Rate: <rate>", line)
        line = re.sub(r"^Compute dtype: .*float32.*", "Compute dtype: fp32",
                      line)
        out.append(line)
    return out


@pytest.mark.parametrize("trainer", ["base", "sr", "cold", "doodle"])
def test_log_lines_match_sdm_tpu(runs, trainer):
    """Banner, step, rate and epoch lines in the same order and format, both
    packages decoding natively; the port names the compute dtype in
    torch's terms (torch.float32)."""
    jax_dir, port_dir = runs[("jax", trainer)], runs[("port", trainer)]
    port = _log(port_dir)
    assert any(line.endswith("Compute dtype: torch.float32") for line in port)
    assert _masked(port, port_dir) == _masked(_log(jax_dir), jax_dir)
    steps = [line for line in port if "Cum. Steps:" in line]
    assert len(steps) == STEPS
    assert re.search(r"Cum\. Steps: 1 \| Steps: 1 / 3 \| Diffusion: "
                     r"[0-9.]+ \| LR: 0\.000100000$", steps[0])


@pytest.mark.parametrize("trainer", ["base", "sr", "cold", "doodle"])
def test_checkpoint_and_preview_files_match_sdm_tpu(runs, trainer):
    jax_dir, port_dir = runs[("jax", trainer)], runs[("port", trainer)]
    for sub in ("checkpoint", "plots"):
        assert (sorted(os.listdir(os.path.join(port_dir, sub)))
                == sorted(os.listdir(os.path.join(jax_dir, sub))))
    # Step 0 checkpoints with a preview; cadence 2; epoch ends at 3 and 5.
    # The doodle trainer also writes its conditioning images' grid.
    plots = sorted(os.listdir(os.path.join(port_dir, "plots")))
    assert plots == sorted(
        [f"diffusion_plot_{s}.jpg" for s in (0, 2, 4)]
        + (["label_plot.jpg"] if trainer == "doodle" else []))
    for name in plots:
        shapes = [cv2.imread(os.path.join(d, "plots", name)).shape
                  for d in (jax_dir, port_dir)]
        assert shapes[0] == shapes[1], name
    for step in (0, 2, 3, 4, 5):
        cfg_j, cfg_t = (torch.load(os.path.join(d, "checkpoint",
                                                f"config_{step}.pt"))
                        for d in (jax_dir, port_dir))
        assert cfg_t == cfg_j
        ck_j, ck_t = (torch.load(os.path.join(d, "checkpoint",
                                              f"diffusion_{step}.pt"))
                      for d in (jax_dir, port_dir))
        assert set(ck_t) == set(ck_j) == {"model", "optimizer"}
        assert set(ck_t["model"]) == set(ck_j["model"])
        assert (ck_t["optimizer"]["param_groups"][0]["lr"]
                == ck_j["optimizer"]["param_groups"][0]["lr"])
        assert (len(ck_t["optimizer"]["state"])
                == len(ck_j["optimizer"]["state"]))


def _fresh(cfg):
    net = UNet.from_config(cfg)
    opt, _ = make_optimizer(net.parameters(), cfg["diffusion_lr"],
                            cfg["lr_steps"])
    return net, opt


@pytest.mark.parametrize("trainer", ["sr", "cold", "doodle"])
def test_sdm_tpu_checkpoint_resumes_in_the_port(runs, images, tmp_path,
                                                trainer):
    """sdm_tpu's step-4 checkpoint loads strictly into the port's model and
    Adam (moments and count), and the port's trainer resumes from it at the
    checkpointed step and lr."""
    src = os.path.join(runs[("jax", trainer)], "checkpoint")
    ckpt = torch.load(os.path.join(src, "diffusion_4.pt"))
    cfg = _config(images, tmp_path, trainer,
                  model_checkpoint=os.path.join(src, "diffusion_4.pt"),
                  config_checkpoint=os.path.join(src, "config_4.pt"),
                  load_diffusion_optim=True)
    net, opt = _fresh(cfg)
    net.load_state_dict(ckpt["model"], strict=True)
    count = load_optimizer_from_checkpoint(ckpt, opt)
    assert count == int(ckpt["optimizer"]["state"][0]["step"]) == 5
    for idx, p in enumerate(net.parameters()):
        for key in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(opt.state[p][key],
                                       ckpt["optimizer"]["state"][idx][key],
                                       rtol=0, atol=0)
    summary = _run_port(SPECS[trainer][1], cfg, steps=6)
    assert summary["global_steps"] == 6
    lines = _log(str(tmp_path))
    assert any("Resuming at checkpointed LR 0.000100000" in line
               for line in lines)
    steps = [line for line in lines if "Cum. Steps:" in line]
    assert steps[0].split("| Diffusion")[0].endswith(
        "Cum. Steps: 5 | Steps: 1 / 3 ")
    assert summary["state"].count == 7


@pytest.mark.parametrize("trainer", ["base", "cold", "doodle"])
def test_port_checkpoint_resumes_in_sdm_tpu(runs, images, tmp_path, trainer):
    """The port's step-4 checkpoint resumes sdm_tpu's trainer, which loads
    it with its own strict-or-log loader: no key is skipped, and its Adam
    state reads the port's moments."""
    from sdm_tpu.io.checkpoint import (load_optimizer_from_checkpoint as
                                       jax_load_optimizer,
                                       load_params_from_checkpoint as
                                       jax_load_params)
    from sdm_tpu.io.torch_interop import params_to_torch_state_dict
    from sdm_tpu.train.step import make_optimizer as jax_make_optimizer
    import jax
    src = os.path.join(runs[("port", trainer)], "checkpoint")
    ckpt = torch.load(os.path.join(src, "diffusion_4.pt"))
    cfg = _config(images, tmp_path, trainer, model_checkpoint=os.path.join(
        src, "diffusion_4.pt"), config_checkpoint=os.path.join(
        src, "config_4.pt"), load_diffusion_optim=True)
    summary = _run_jax(SPECS[trainer][0], cfg, steps=5)
    assert summary["global_steps"] == 5
    lines = _log(str(tmp_path))
    assert not any("Skipped" in line or "No Layer found" in line
                   for line in lines)
    assert any("Resuming at checkpointed LR 0.000100000" in line
               for line in lines)
    assert any("Cum. Steps: 5 | Steps: 1 / 3" in line for line in lines)

    params = jax.tree.map(np.asarray, summary["state"].params)
    loaded = jax_load_params(ckpt, params, log=pytest.fail)
    sd = params_to_torch_state_dict(loaded)
    for name, value in ckpt["model"].items():
        np.testing.assert_array_equal(sd[name].numpy(), value.numpy())
    tx = jax_make_optimizer(1e-4, 100)
    adam = jax_load_optimizer(ckpt, loaded, tx.init(loaded))[0]
    assert int(adam.count) == int(ckpt["optimizer"]["state"][0]["step"])
    mu = params_to_torch_state_dict(jax.tree.map(np.asarray, adam.mu))
    names = list(ckpt["model"])
    for idx, name in enumerate(names):
        np.testing.assert_array_equal(
            mu[name].numpy(), ckpt["optimizer"]["state"][idx]["exp_avg"])


def test_resume_lr_continues_from_the_checkpointed_lr(runs, images,
                                                      tmp_path):
    """With load_diffusion_optim the lr comes from the checkpoint's
    param_groups, not the config, and halves every lr_steps from there
    (sdm_tpu's resume_lr_schedule)."""
    src = os.path.join(runs[("port", "base")], "checkpoint")
    ckpt = torch.load(os.path.join(src, "diffusion_2.pt"))
    ckpt["optimizer"]["param_groups"][0]["lr"] = 3e-5
    path = os.path.join(str(tmp_path), "resume.pt")
    torch.save(ckpt, path)
    cfg = _config(images, tmp_path, model_checkpoint=path,
                  config_checkpoint=os.path.join(src, "config_2.pt"),
                  load_diffusion_optim=True, lr_steps=2, diffusion_lr=1e-3)
    summary = _run_port(loop.BASE_SPEC, cfg, steps=6)
    want = resume_lr_schedule(3e-5, 2, 2)
    logged = [float(line.rsplit("LR: ", 1)[1]) for line in _log(str(tmp_path))
              if "Cum. Steps:" in line]
    assert logged == pytest.approx([float(want(s)) for s in range(2, 6)])
    assert summary["state"].optimizer.param_groups[0]["lr"] == pytest.approx(
        float(want(summary["state"].count - 1)))


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


def _step_wrapper(monkeypatch, hook):
    """Wrap the trainer's step so `hook(call_index, metrics)` runs after
    each step and may replace its metrics."""
    real = loop.make_train_step

    def make(*args, **kwargs):
        step = real(*args, **kwargs)
        calls = []

        def wrapped(state, batch, generator=None):
            metrics = step(state, batch, generator)
            calls.append(1)
            return hook(len(calls), metrics)
        return wrapped
    monkeypatch.setattr(loop, "make_train_step", make)


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


def test_step_zero_checkpoint_reloads_strictly(runs):
    """The port's step-0 checkpoint loads into a fresh model and Adam with
    strict keys, non-zero moments and the one step taken."""
    src = os.path.join(runs[("port", "sr")], "checkpoint", "diffusion_0.pt")
    ok, ckpt = load_checkpoint(src, log=lambda *a: None)
    assert ok
    net, opt = _fresh(_config("x", "y", "sr"))
    net.load_state_dict(ckpt["model"], strict=True)
    assert load_optimizer_from_checkpoint(ckpt, opt) == 1
    moments = [opt.state[p]["exp_avg"] for p in net.parameters()]
    assert len(moments) == len(list(net.parameters()))
    assert any(float(m.abs().max()) > 0 for m in moments)


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


# ---- "native_checkpoint" and "profile_trace_dir" ----

def test_native_checkpoint_dirs_match_sdm_tpu(runs):
    """Both base trainers with "native_checkpoint" write native_<step>
    beside each .pt pair, under the same names (sdm_tpu's an orbax
    directory, the port's a torch.distributed.checkpoint one)."""
    names = {pkg: sorted(os.listdir(os.path.join(runs[(pkg, "base")],
                                                 "checkpoint")))
             for pkg in ("jax", "port")}
    assert names["port"] == names["jax"]
    native = [n for n in names["port"] if n.startswith("native_")]
    assert native == [f"native_{s}" for s in (0, 2, 3, 4, 5)]
    for n in native:
        files = os.listdir(os.path.join(runs[("port", "base")],
                                        "checkpoint", n))
        assert ".metadata" in files and any(f.endswith(".distcp")
                                            for f in files), files


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
