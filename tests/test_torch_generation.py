"""The port's generator (sdm_tpu_torch/cli/generate_images_diffusion: DDIM,
DDPM, DPM-Solver++(2M), Heun, Karras spacing, img2img, inpainting and
classifier-free guidance) against sdm_tpu's, on CPU at a small size.

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


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """PNGs at the bundles' size: an init/inpaint image, a half-image keep
    mask (left half white), a mask of another size and an image of
    another size."""
    cv2 = pytest.importorskip("cv2")
    tmp = tmp_path_factory.mktemp("gen_images")
    rng = np.random.default_rng(11)
    paths = {}
    mask = np.zeros((IMG, IMG), np.uint8)
    mask[:, :IMG // 2] = 255
    for name, img in (
            ("init", rng.integers(0, 256, (IMG, IMG, 3), dtype=np.uint8)),
            ("mask", mask), ("small_mask", mask[:8, :8]),
            ("small", rng.integers(0, 256, (8, 8, 3), dtype=np.uint8))):
        paths[name] = str(tmp / f"{name}.png")
        cv2.imwrite(paths[name], img)
    return paths


def _ext_flags(case, images):
    return {
        "dpmpp": ["--diff_alg", "dpmpp"],
        "heun": ["--diff_alg", "heun"],
        "karras": ["--diff_alg", "ddim", "--karras"],
        "dpmpp+karras": ["--diff_alg", "dpmpp", "--karras"],
        "img2img": ["--diff_alg", "ddim", "--init_img_path",
                    images["init"], "--init_noise_step", "7"],
        "img2img+ddpm": ["--diff_alg", "ddpm", "--init_img_path",
                         images["init"], "--init_noise_step", "7"],
        "inpaint": ["--diff_alg", "ddim", "--inpaint_img_path",
                    images["init"], "--inpaint_mask_path", images["mask"]],
        "inpaint+heun+karras": ["--diff_alg", "heun", "--karras",
                                "--inpaint_img_path", images["init"],
                                "--inpaint_mask_path", images["mask"]],
        "guidance": ["--diff_alg", "ddim", "--guidance-scale", "3.0"],
        "guidance+dpmpp": ["--diff_alg", "dpmpp", "--guidance-scale",
                           "0.0"]}[case]


@pytest.mark.parametrize("bundle,case", [
    ("one", "dpmpp"), ("one", "heun"), ("one", "karras"),
    ("ensemble", "dpmpp+karras"), ("one", "img2img"),
    ("ensemble", "img2img+ddpm"), ("one", "inpaint"),
    ("ensemble", "inpaint+heun+karras"), ("one", "guidance"),
    ("ensemble", "guidance+dpmpp")])
def test_generator_extensions_match_sdm_tpu(bundles, images, bundle, case):
    """--diff_alg dpmpp|heun, --karras, img2img, inpainting and
    --guidance-scale, each against sdm_tpu's generator from the same
    seed."""
    config, ranges = bundles[bundle]
    flags = _ext_flags(case, images)
    args = ["-c", config, "-n", str(N), "--ddim_step_size", "3", "-T",
            str(T), "-s", str(SEED), "--device", "cpu", "-l", *LABELS]
    ref = np.asarray(jax_generate(args + flags, **QUIET))
    if "img2img" in case:          # the first model samples from step 7
        ranges = [(lo, min(hi, 7)) for lo, hi in ranges[:1]] + ranges[1:]
    noise, zs = _sdm_tpu_noise("ddpm" if "ddpm" in case else "ddim", ranges)
    ours = generate_images_diffusion(args + flags, noise=noise, zs=zs,
                                     **QUIET)
    assert ours.shape == (N, IMG, IMG, 3) and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, **TRAJ_TOL)
    if "inpaint" in case:          # the kept half is the image's own
        import cv2
        known = (cv2.imread(images["init"]).astype(np.float32)
                 - 127.5) / 127.5
        np.testing.assert_allclose(ours[:, :, :IMG // 2],
                                   np.broadcast_to(known[:, :IMG // 2],
                                                   ours[:, :, :IMG // 2]
                                                   .shape), atol=1e-6)


@pytest.mark.parametrize("case", [
    "karras+ddpm", "init_without_step", "step_without_init",
    "init_missing", "init_step_out_of_range", "init_wrong_size",
    "inpaint_without_mask", "inpaint_ddpm", "inpaint_and_init",
    "inpaint_mask_missing", "inpaint_mask_wrong_size",
    "inpaint_wrong_size", "guidance_without_labels"])
def test_extension_validation_matches_sdm_tpu(bundles, images, tmp_path,
                                              case):
    """Each refusal of the extension flags raises sdm_tpu's error with
    sdm_tpu's message."""
    config, _ = bundles["one"]
    flags = {
        "karras+ddpm": ["--diff_alg", "ddpm", "--karras"],
        "init_without_step": ["--init_img_path", images["init"]],
        "step_without_init": ["--init_noise_step", "5"],
        "init_missing": ["--init_img_path", str(tmp_path / "no.png"),
                         "--init_noise_step", "5"],
        "init_step_out_of_range": ["--init_img_path", images["init"],
                                   "--init_noise_step", str(T + 1)],
        "init_wrong_size": ["--init_img_path", images["small"],
                            "--init_noise_step", "5"],
        "inpaint_without_mask": ["--inpaint_img_path", images["init"]],
        "inpaint_ddpm": ["--diff_alg", "ddpm", "--inpaint_img_path",
                         images["init"], "--inpaint_mask_path",
                         images["mask"]],
        "inpaint_and_init": ["--diff_alg", "ddim", "--inpaint_img_path",
                             images["init"], "--inpaint_mask_path",
                             images["mask"], "--init_img_path",
                             images["init"], "--init_noise_step", "5"],
        "inpaint_mask_missing": ["--diff_alg", "ddim", "--inpaint_img_path",
                                 images["init"], "--inpaint_mask_path",
                                 str(tmp_path / "no.png")],
        "inpaint_mask_wrong_size": ["--diff_alg", "ddim",
                                    "--inpaint_img_path", images["init"],
                                    "--inpaint_mask_path",
                                    images["small_mask"]],
        "inpaint_wrong_size": ["--diff_alg", "ddim", "--inpaint_img_path",
                               images["small"], "--inpaint_mask_path",
                               images["small_mask"]],
        "guidance_without_labels": ["--guidance-scale", "2.0"],
    }[case]
    if case == "guidance_without_labels":
        config, _ = bundles["doodle"]
        kw = dict(cond_img=np.zeros((IMG, IMG, 3), np.uint8))
        base = ["-c", config, "-T", str(T), "--device", "cpu"]
    else:
        kw = {}
        base = ["-c", config, "-T", str(T), "--device", "cpu", "-l",
                *LABELS]
    got = _error(generate_images_diffusion, base + flags, **kw)
    assert got == _error(jax_generate, base + flags, **kw)


@pytest.mark.parametrize("generator", ["ddim_ddpm", "cold", "sr"])
def test_unported_flags_name_their_roadmap_item(bundles, generator):
    """--sp is ported in all three generators (the data-parallel, pipeline
    and spatial paths run in tests/test_torch_parallel.py and
    tests/test_torch_model_parallel.py). Its checks raise sdm_tpu's error
    before any rank starts: here the height (16) that does not divide by
    --sp 3."""
    from sdm_tpu.cli.generate_images_cold_diffusion import \
        generate_images_cold_diffusion as jax_cold
    from sdm_tpu.cli.generate_sr_images_diffusion import \
        generate_sr_images_diffusion as jax_sr
    from sdm_tpu_torch.cli.generate_images_cold_diffusion import \
        generate_images_cold_diffusion
    from sdm_tpu_torch.cli.generate_sr_images_diffusion import \
        generate_sr_images_diffusion
    config, _ = bundles["one"]
    fns = {"ddim_ddpm": (generate_images_diffusion, jax_generate),
           "cold": (generate_images_cold_diffusion, jax_cold),
           "sr": (generate_sr_images_diffusion, jax_sr)}[generator]
    kw = ({"lr_img": np.zeros((IMG // 2, IMG // 2, 3), np.uint8)}
          if generator == "sr" else {})
    args = ["-c", config, "--device", "cpu", "-l", *LABELS, "--sp", "3"]
    got = _error(fns[0], args, **kw)
    assert got == (ValueError,
                   f'"image" height {IMG} must be divisible by sp=3')
    assert got == _error(fns[1], args, **kw)


def test_device_defaults_to_cuda(bundles):
    assert _parser().parse_args(["-c", "x.json"]).device == "cuda"
    if not torch.cuda.is_available():
        config, _ = bundles["one"]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            generate_images_diffusion(["-c", config, "-l", *LABELS], **QUIET)
