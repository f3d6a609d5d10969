"""The port's trainers (sdm_tpu_torch/train/loop.py: BASE_SPEC, SR_SPEC,
COLD_SPEC and DOODLE_SPEC) against sdm_tpu's, on a tiny U-Net and six
cv2-written 8x8 images (paired, for the doodle trainer, with six 8x8
conditioning images through a TinyDB file).

The two packages draw their noise from different generators, so the losses
differ; everything else is held equal: the log lines (timestamps, paths and
loss values masked), the checkpoint and preview file names, and the
checkpoints' contents. A checkpoint of either package resumes in the other,
strictly, with its Adam moments and step count, and the port's resume
continues the checkpointed LR. Both packages draw the doodle preview batch
unseeded, so its preview and label_plot grids are held by name and shape,
as every trainer's are, never by pixels. Both packages decode natively
(their loaders' default). The base trainers of both packages write native
checkpoints ("native_checkpoint"), under the same names. The port's other
options and semantics are held in test_torch_train_loop_options.py, its
fused device-resident loop and traces in test_torch_train_loop_fused.py,
on this file's configs and images (the files run on separate workers).
"""

import os
import re

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from sdm_tpu.train import loop as jax_loop  # noqa: E402
from sdm_tpu.train.step import resume_lr_schedule  # noqa: E402
from sdm_tpu_torch.data.tinydb_compat import write_tables  # noqa: E402
from sdm_tpu_torch.io.checkpoint import (  # noqa: E402
    load_checkpoint, load_optimizer_from_checkpoint)
from sdm_tpu_torch.models import UNet  # noqa: E402
from sdm_tpu_torch.train import loop  # noqa: E402
from sdm_tpu_torch.train.step import make_optimizer  # noqa: E402

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
