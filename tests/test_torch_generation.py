"""The port's DDIM/DDPM generator (sdm_tpu_torch/cli/generate_images_diffusion)
against sdm_tpu's, on CPU at a small size.

Three bundles, exported by the port from sdm_tpu's own init weights: one
label-conditional model over steps 1..T, a two-entry ensemble of
label-conditional models (steps T..6, then 5..1) that chains x_t from model
to model, and a doodle model (six input channels: x_t and the conditioning
image). Both generators run the same bundle from the same seed; sdm_tpu's
noise (x_T, and for DDPM each model's per-step z) is reproduced here from
that seed and handed to the port.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdm_tpu.cli.generate_images_diffusion import \
    generate_images_diffusion as jax_generate
from sdm_tpu.io.checkpoint import diffusion_checkpoint_dict
from sdm_tpu.models import UNet as JaxUNet
from sdm_tpu_torch.cli.export_models import export_bundle
from sdm_tpu_torch.cli.generate_images_diffusion import (
    _parser, generate_images_diffusion)

# Whole trajectories through the U-Net, fp32 in another order (as
# tests/test_torch_sr.py).
TRAJ_TOL = dict(atol=1e-4, rtol=1e-3)
T = 10
IMG = 16
N = 2
SEED = 5
LABELS = ["0.25", "-0.5"]
MODEL = dict(in_channel=3, out_channel=3, num_layers=2, num_resnet_block=1,
             attn_layers=[1], attn_heads=1, attn_dim_per_head=None,
             time_dim=16, cond_dim=2, min_channel=32, max_channel=64,
             img_recon=False)
DOODLE = dict(MODEL, in_channel=6, cond_dim=None)
QUIET = dict(log=lambda *a, **k: None, save_locally=False)


def _params(model, seed):
    net = JaxUNet(num_resnet_blocks=1, in_channel=model["in_channel"],
                  out_channel=3, time_dim=16, cond_dim=model["cond_dim"],
                  num_layers=2, attn_layers=(1,), min_channel=32,
                  max_channel=64, use_pallas=False)
    labels = (None if model["cond_dim"] is None
              else jnp.zeros((model["cond_dim"],)))
    params = net.init(jax.random.PRNGKey(seed),
                      jnp.zeros((1, IMG, IMG, model["in_channel"])),
                      jnp.array([1]), labels)["params"]
    return jax.tree.map(np.asarray, params)


def _train_cfg(model, min_noise, max_noise):
    return dict(model, min_noise_step=min_noise, max_noise_step=max_noise,
                noise_scheduler="LINEAR", beta1=5e-3, betaT=9e-3)


def _export(tmp, name, model, ranges):
    entries = []
    for i, (lo, hi) in enumerate(ranges):
        path = str(tmp / f"{name}{i}.pt")
        torch.save(diffusion_checkpoint_dict(_params(model, 20 + i)), path)
        entries.append((_train_cfg(model, lo, hi), path))
    out = export_bundle(name, str(tmp), img_c=3, img_h=IMG, img_w=IMG,
                        model_type="BASE", entries=entries)
    return os.path.join(out, "config.json")


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gen_bundles")
    return {"one": (_export(tmp, "one", MODEL, [(1, T)]), [(1, T)]),
            "ensemble": (_export(tmp, "ens", MODEL, [(6, T), (1, 5)]),
                         [(6, T), (1, 5)]),
            "doodle": (_export(tmp, "doodle", DOODLE, [(1, T)]), [(1, T)])}


def _sdm_tpu_noise(alg, ranges):
    """x_T and, for DDPM, each model's per-step z, as sdm_tpu's generator
    draws them from SEED."""
    shape = (N, IMG, IMG, 3)
    rng, nk = jax.random.split(jax.random.PRNGKey(SEED))
    noise = np.asarray(jax.random.normal(nk, shape, jnp.float32))
    if alg != "ddpm":
        return noise, None
    zs = []
    for lo, hi in ranges:
        rng, sk = jax.random.split(rng)
        keys = jax.random.split(sk, hi - lo + 1)
        zs.append(np.stack([np.asarray(jax.random.normal(k, shape,
                                                         jnp.float32))
                            for k in keys]))
    return noise, zs


@pytest.mark.parametrize("bundle,alg", [
    ("one", "ddim"), ("one", "ddpm"), ("ensemble", "ddim"),
    ("ensemble", "ddpm"), ("doodle", "ddim"), ("doodle", "ddpm")])
def test_generator_matches_sdm_tpu(bundles, bundle, alg):
    config, ranges = bundles[bundle]
    args = ["-c", config, "-n", str(N), "--diff_alg", alg,
            "--ddim_step_size", "3", "-T", str(T), "-s", str(SEED),
            "--num-devices", "1", "--device", "cpu"]
    extra = {}
    if bundle == "doodle":
        extra["cond_img"] = np.random.default_rng(4).integers(
            0, 256, (IMG, IMG, 3), dtype=np.uint8)
    else:
        args += ["-l", *LABELS]
    ref = np.asarray(jax_generate(args, **extra, **QUIET))
    noise, zs = _sdm_tpu_noise(alg, ranges)
    ours = generate_images_diffusion(args, noise=noise, zs=zs, **extra,
                                     **QUIET)
    assert ours.shape == (N, IMG, IMG, 3)
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, **TRAJ_TOL)


def test_generator_saves_a_grid(bundles, tmp_path):
    config, _ = bundles["one"]
    args = ["-c", config, "-n", str(N), "--diff_alg", "ddim",
            "--ddim_step_size", "5", "-T", str(T), "-s", "1", "-l", *LABELS,
            "-d", str(tmp_path), "--device", "cpu"]
    assert generate_images_diffusion(args, log=lambda *a: None) is None
    (name,) = os.listdir(tmp_path / "plots")
    assert name.endswith(".jpg") and f"_({IMG},{IMG})_" in name


def _error(fn, args, **kw):
    try:
        fn(args, **kw, **QUIET)
    except (ValueError, FileNotFoundError) as e:
        return type(e), str(e)
    raise AssertionError(f"{args} did not raise")


def test_validation_matches_sdm_tpu(bundles, tmp_path):
    """Each refusal both generators share raises the same error with the
    same message."""
    config, _ = bundles["one"]
    base = ["-c", config, "-T", str(T), "--device", "cpu"]
    not_img = tmp_path / "x.png"
    not_img.write_bytes(b"not an image")
    cases = [
        (base + ["-n", "0"], {}),
        (base + ["-d", str(tmp_path / "missing")], {}),
        (base + ["--diff_alg", "ddim", "--ddim_step_size", str(T + 1)], {}),
        (base + ["--cond_img_path", str(tmp_path / "missing.png")], {}),
        (base + ["--cond_img_path", str(not_img)], {}),
        (base, dict(cond_img=[[1]])),
        (base, {}),                                   # no labels
        (base + ["-l", "1.0"], {}),                   # one label of two
        (["-c", str(tmp_path / "nope.json"), "--device", "cpu"], {}),
    ]
    for args, kw in cases:
        assert (_error(generate_images_diffusion, args, **kw)
                == _error(jax_generate, args, **kw)), args


@pytest.mark.parametrize("flags,item", [
    (["--diff_alg", "dpmpp"], "item 6"), (["--diff_alg", "heun"], "item 6"),
    (["--diff_alg", "ddim", "--karras"], "item 6"),
    (["--init_img_path", "x.png", "--init_noise_step", "5"], "item 6"),
    (["--inpaint_img_path", "x.png", "--inpaint_mask_path", "m.png"],
     "item 6"),
    (["--guidance-scale", "2.0"], "item 6"),
    (["--num-devices", "2"], "item 9"), (["--sp", "2"], "item 9"),
    (["--pipeline", "2"], "item 9")])
def test_unported_flags_name_their_roadmap_item(bundles, flags, item):
    config, _ = bundles["one"]
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP Queue 1 {item}"):
        generate_images_diffusion(["-c", config, "--device", "cpu", "-l",
                                   *LABELS] + flags, **QUIET)


def test_device_defaults_to_cuda(bundles):
    assert _parser().parse_args(["-c", "x.json"]).device == "cuda"
    if not torch.cuda.is_available():
        config, _ = bundles["one"]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            generate_images_diffusion(["-c", config, "-l", *LABELS], **QUIET)
