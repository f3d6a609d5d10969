"""The port's config wizards and export prompt (sdm_tpu_torch/cli/
config_wizards.py, create_*_config.py, export_models.py) against sdm_tpu's,
and the whole user flow through the port's entry points alone.

Each prompt flow is fed the same piped answers in both packages: the
transcripts (every prompt, in order, with its default) and the JSON they
write must be identical. Then, on the CPU, each of the three trainer kinds
runs as a user would: a wizard writes the config, the trainer's CLI trains,
the export prompt makes a bundle, and a generator samples from it.
"""

import json
import os

import click.testing
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from sdm_tpu.cli import config_wizards as jax_wizards  # noqa: E402
from sdm_tpu.cli import export_models as jax_export  # noqa: E402
from sdm_tpu_torch.cli import (create_diffusion_config,  # noqa: E402
                               create_doodle_diffusion_config,
                               create_sr_diffusion_config, export_models,
                               generate_images_cold_diffusion,
                               generate_images_diffusion,
                               train_diffusion, train_doodle_diffusion,
                               train_noise_cold_diffusion)
from sdm_tpu_torch.cli import config_wizards  # noqa: E402
from sdm_tpu_torch.data.tinydb_compat import write_tables  # noqa: E402
from sdm_tpu_torch.models import UNet  # noqa: E402


def _drive(fn, answers):
    """Run a prompt flow on piped answers; returns its transcript."""
    runner = click.testing.CliRunner()
    with runner.isolation(input="".join(a + "\n" for a in answers)) as out:
        fn()
    return out[0].getvalue().decode()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Six 8x8 images, six 8x8 doodles, a TinyDB file pairing them and a
    file standing for a checkpoint."""
    d = tmp_path_factory.mktemp("wizard_data")
    rng = np.random.default_rng(0)
    rows = []
    for i in range(6):
        for kind in ("im", "doodle"):
            cv2.imwrite(str(d / f"{kind}_{i}.png"),
                        rng.integers(0, 256, (8, 8, 3), dtype=np.uint8))
        rows.append({"filename": str(d / f"im_{i}.png"),
                     "doodle": str(d / f"doodle_{i}.png")})
    write_tables(str(d / "db.json"),
                 {"Data": rows, "Labels": [{"labels": ["doodle"]}]})
    (d / "ckpt.pt").write_bytes(b"x")
    return d


def _base_answers(d, nondefault):
    if not nondefault:          # every default, unconditional, DDPM
        return (["n", str(d / "im_*.png"), str(d / "out")] + [""] * 5
                + ["n", "n"] + [""] * 13 + ["n", "n", "y", "y"] + [""] * 6
                + ["y"])
    return ["y", str(d / "db.json"), "3", str(d / "out"), "5", "50", "3",
            "6", "n", "y", str(d / "ckpt.pt"), "y", "y", str(d / "ckpt.pt"),
            "1e-4", "4", "cosine", "COLD", "50", "2", "500", "400", "3", "3",
            "2", "2", "y", "n", "2", "16", "64", "32", "64", "y", "y"]


def _sr_answers(d, nondefault):
    if not nondefault:
        return (["", "", "n", str(d / "im_*.png"), str(d / "out")]
                + [""] * 5 + ["n", "n"] + [""] * 14 + ["n", "n", "y", "y"]
                + [""] * 6 + ["y"])
    return ["64", "128", "n", str(d / "im_*.png"), str(d / "out"), "5", "50",
            "3", "6", "y", "n", "n", "1e-4", "4", "LINEAR", "1e-3", "2e-2",
            "25", "1", "800", "800", "100", "6", "3", "3", "1", "n", "y",
            "y", "1", "-1", "32", "32", "128", "n", "y"]


def _doodle_answers(d, nondefault):
    if not nondefault:
        return ([str(d / "db.json"), str(d / "out")] + [""] * 4
                + ["n", "n"] + [""] * 13 + ["n", "n", "y", "y"] + [""] * 5
                + ["y"])
    return [str(d / "db.json"), str(d / "out"), "5", "50", "3", "6", "y",
            str(d / "ckpt.pt"), "n", "n", "1e-4", "4", "cosine", "ddim",
            "20", "1", "500", "500", "6", "3", "2", "1", "y", "y", "4",
            "-1", "16", "32", "64", "y"]


WIZARDS = {"base": ("create_diffusion_config", _base_answers),
           "sr": ("create_sr_diffusion_config", _sr_answers),
           "doodle": ("create_doodle_diffusion_config", _doodle_answers)}


@pytest.mark.parametrize("nondefault", [False, True],
                         ids=["defaults", "answered"])
@pytest.mark.parametrize("kind", ["base", "sr", "doodle"])
def test_wizard_json_matches_sdm_tpu(data, tmp_path, kind, nondefault):
    fn_name, answers = WIZARDS[kind]
    out = {}
    for pkg, mod in (("sdm_tpu", jax_wizards), ("port", config_wizards)):
        dest = tmp_path / pkg
        dest.mkdir()
        transcript = _drive(getattr(mod, fn_name),
                            ["cfg", str(dest)] + answers(data, nondefault))
        with open(dest / "cfg.json") as f:
            out[pkg] = (transcript.replace(str(dest), "<dest>"), f.read())
    assert out["port"] == out["sdm_tpu"]
    cfg = json.loads(out["port"][1])
    assert cfg["out_dir"] == str(data / "out")
    if nondefault:
        assert cfg["batch_size"] == 4 and cfg["diffusion_lr"] == 1e-4


def test_create_config_entry_points_run_the_wizards(monkeypatch):
    called = []
    for mod, name in ((create_diffusion_config, "create_diffusion_config"),
                      (create_sr_diffusion_config,
                       "create_sr_diffusion_config"),
                      (create_doodle_diffusion_config,
                       "create_doodle_diffusion_config")):
        monkeypatch.setattr(mod, name, lambda n=name: called.append(n))
        mod.run()
    assert called == ["create_diffusion_config", "create_sr_diffusion_config",
                      "create_doodle_diffusion_config"]


def _train_config(path, model_type):
    cfg = dict(in_channel=3, out_channel=3, num_layers=1, num_resnet_block=1,
               attn_layers=[0], attn_heads=1, attn_dim_per_head=None,
               time_dim=8, cond_dim=None, min_channel=32, max_channel=32,
               img_recon=False, min_noise_step=1, max_noise_step=10,
               noise_scheduler="COSINE", beta1=5e-3, betaT=9e-3)
    if model_type == "SR":
        cfg.update(in_channel=6, img_recon=True, cond_t=5)
    with open(path, "w") as f:
        json.dump(cfg, f)


@pytest.mark.parametrize("model_type,count", [("BASE", 1), ("BASE-COLD", 2),
                                              ("SR", 1)])
def test_export_prompt_matches_sdm_tpu(data, tmp_path, model_type, count):
    """The same answers give the same transcript, the same bundle
    config.json and the same checkpoint files."""
    cfgs = []
    for i in range(count):
        path = tmp_path / f"train_{i}.json"
        _train_config(path, model_type)
        cfgs += [str(path), str(data / "ckpt.pt")]
    out = {}
    for pkg, fn in (("sdm_tpu", jax_export.export_models),
                    ("port", export_models.export_models)):
        dest = tmp_path / pkg
        dest.mkdir()
        transcript = _drive(fn, ["bundle", str(dest), "3", "8", "8",
                                 model_type.lower(), str(count)] + cfgs)
        bundle = dest / "bundle"
        with open(bundle / "config.json") as f:
            out[pkg] = (transcript.replace(str(dest), "<dest>"), f.read(),
                        sorted(os.listdir(bundle)))
    assert out["port"] == out["sdm_tpu"]
    assert len(json.loads(out["port"][1])["models"]) == count


# ------------------------------------------------------------- the flow

FLOW = {
    # kind: (wizard, wizard answers after name and dest, trainer CLI,
    #        export model type)
    "base": (config_wizards.create_diffusion_config,
             lambda d: ["n", str(d / "im_*.png"), str(d / "out_base"), "2",
                        "100", "2", "4", "", "n", "n", "", "2", "", "", "",
                        "DDIM", "4", "", "10", "10", "", "", "1", "1", "y",
                        "", "-1", "8", "32", "32", "", "y"],
             train_diffusion, "BASE"),
    "cold": (config_wizards.create_diffusion_config,
             lambda d: ["n", str(d / "im_*.png"), str(d / "out_cold"), "2",
                        "100", "2", "4", "", "n", "n", "", "2", "", "", "",
                        "COLD", "4", "", "10", "10", "", "", "1", "1", "y",
                        "", "-1", "8", "32", "32", "y", "y"],
             train_noise_cold_diffusion, "BASE-COLD"),
    "doodle": (config_wizards.create_doodle_diffusion_config,
               lambda d: [str(d / "db.json"), str(d / "out_doodle"), "2",
                          "100", "2", "4", "n", "n", "", "2", "", "", "",
                          "DDIM", "4", "", "10", "10", "", "", "1", "1", "y",
                          "", "-1", "8", "32", "32", "y"],
               train_doodle_diffusion, "BASE"),
}


@pytest.mark.parametrize("kind", ["base", "cold", "doodle"])
def test_wizard_train_export_generate_through_the_port(data, tmp_path, kind):
    """wizard -> trainer CLI -> export prompt -> generator, each a port
    entry point, on the CPU; the trained checkpoint loads strictly and the
    generator writes a grid of finite images."""
    wizard, answers, trainer, model_type = FLOW[kind]
    _drive(wizard, ["tiny", str(tmp_path)] + answers(data))
    cfg_path = tmp_path / "tiny.json"
    with open(cfg_path) as f:
        cfg = json.load(f)
    # Two epochs of three batches of two; checkpoints every 2 steps.
    summary = trainer.run(["-c", str(cfg_path), "--device", "cpu"])
    assert summary["global_steps"] == 6
    assert np.isfinite(summary["last_loss"])
    ckpt_path = os.path.join(cfg["out_dir"], "checkpoint", "diffusion_6.pt")
    net = UNet.from_config(cfg)
    net.load_state_dict(torch.load(ckpt_path)["model"], strict=True)
    plots = sorted(os.listdir(os.path.join(cfg["out_dir"], "plots")))
    assert "diffusion_plot_0.jpg" in plots
    assert ("label_plot.jpg" in plots) == (kind == "doodle")

    export = tmp_path / "export"
    export.mkdir()
    _drive(export_models.run,
           ["bundle", str(export), "3", "8", "8", model_type, "1",
            str(cfg_path), ckpt_path])
    bundle = str(export / "bundle" / "config.json")
    dest = tmp_path / "gen"
    dest.mkdir()
    quiet = dict(log=lambda *a, **k: None)
    common = ["-c", bundle, "-n", "4", "-d", str(dest), "-s", "42",
              "--device", "cpu"]
    if kind == "cold":
        gen = generate_images_cold_diffusion.generate_images_cold_diffusion
        args = common + ["--cold_step_size", "4"]
    else:
        gen = generate_images_diffusion.generate_images_diffusion
        args = common + ["--diff_alg", "ddim", "--ddim_step_size", "4"]
        if kind == "doodle":
            args += ["--cond_img_path", str(data / "doodle_0.png")]
    assert gen(args, **quiet) is None
    (grid,) = os.listdir(dest / "plots")
    assert grid.endswith(".jpg")
    images = gen(args, save_locally=False, **quiet)
    assert images.shape == (4, 8, 8, 3) and np.isfinite(images).all()
