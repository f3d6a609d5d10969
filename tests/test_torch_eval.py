"""The port's sample-quality evaluation (sdm_tpu_torch/eval and
cli/evaluate_samples.py) against sdm_tpu's.

The distances run on the same features in both packages; the features on
the same images; the randconv weights file against sdm_tpu's own draw;
the CLI on directories of cv2-written images and on an exported bundle.
Everything runs on the CPU.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

cv2 = pytest.importorskip("cv2")

from sdm_tpu.cli.evaluate_samples import \
    evaluate_samples as jax_evaluate  # noqa: E402
from sdm_tpu.eval import fid as jax_fid  # noqa: E402
from sdm_tpu.eval.features import \
    make_feature_extractor as jax_extractor  # noqa: E402
from sdm_tpu_torch.cli.evaluate_samples import evaluate_samples  # noqa: E402
from sdm_tpu_torch.cli.export_models import export_bundle  # noqa: E402
from sdm_tpu_torch.eval import fid, make_feature_extractor  # noqa: E402
from sdm_tpu_torch.eval.features import (RANDCONV_WEIGHTS,  # noqa: E402
                                         randconv_kernels, same_padding)
from sdm_tpu_torch.models import UNet  # noqa: E402

# float64 numpy in both packages, the same operations.
FID_TOL = 1e-10
# Pixel features: the same fp32 area averages.
PIXEL_TOL = 1e-6
# randconv: four bf16 convs and swishes (8 mantissa bits, each rounding at
# 2^-9 relative) in another summation order, then fp32 pooling; measured
# 6e-3 to 8.3e-3 normwise on this box.
RANDCONV_TOL = 2e-2


def _images(n, size, channels=3, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (n, size, size, channels)).astype(np.float32)


def _write_images(d, n, size, seed):
    """n seeded uint8 BGR PNGs in d (the eval CLI reads them with cv2)."""
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        cv2.imwrite(os.path.join(d, f"img_{i}.png"),
                    rng.integers(0, 256, (size, size, 3), dtype=np.uint8))
    return str(d)


def test_distances_match_sdm_tpu():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((40, 12))
    b = rng.standard_normal((30, 12)) * 1.3 + 0.2
    for pkg in (fid, jax_fid):
        assert pkg.frechet_from_features(a, a) < FID_TOL
    mu_t, sig_t = fid.gaussian_stats(a)
    mu_j, sig_j = jax_fid.gaussian_stats(a)
    np.testing.assert_allclose(mu_t, mu_j, rtol=0, atol=FID_TOL)
    np.testing.assert_allclose(sig_t, sig_j, rtol=0, atol=FID_TOL)
    np.testing.assert_allclose(fid.frechet_from_features(a, b),
                               jax_fid.frechet_from_features(a, b),
                               rtol=FID_TOL)
    for block in (1024, 8):
        np.testing.assert_allclose(
            fid.kernel_distance(a, b, block_size=block, seed=3),
            jax_fid.kernel_distance(a, b, block_size=block, seed=3),
            rtol=FID_TOL, atol=FID_TOL)
    with pytest.raises(ValueError, match="at least 2 samples"):
        fid.gaussian_stats(a[:1])


@pytest.mark.parametrize("spec,shape", [
    ("pixel", (10, 32, 32, 3)), ("pixel:5", (7, 17, 17, 6)),
    ("randconv", (10, 32, 32, 3)), ("randconv:33", (5, 24, 24, 1)),
    ("randconv:16", (7, 16, 16, 6))])
def test_features_match_sdm_tpu(spec, shape):
    """The same images through both packages' extractors (batch 4, so the
    last batch is padded): pixel within PIXEL_TOL, randconv normwise
    within RANDCONV_TOL, the same canonical names and shapes."""
    x = _images(*shape[:2], shape[3])[:, :, :shape[2]]
    f_j, name_j = jax_extractor(spec, batch_size=4)
    f_t, name_t = make_feature_extractor(spec, batch_size=4, device="cpu")
    assert name_t == name_j
    want, got = f_j(x), f_t(x)
    assert got.shape == want.shape and got.dtype == np.float32
    if spec.startswith("pixel"):
        np.testing.assert_allclose(got, want, rtol=0, atol=PIXEL_TOL)
    else:
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= RANDCONV_TOL, rel


def test_randconv_weights_are_sdm_tpus_bit_for_bit():
    """The committed file, regenerated through sdm_tpu's _randconv_params
    for 1, 3 and 6 input channels, equals it bit for bit."""
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "tools"))
    from torch_write_randconv import randconv_arrays

    from sdm_tpu.eval.features import _randconv_params
    want = randconv_arrays()
    with np.load(RANDCONV_WEIGHTS) as z:
        assert sorted(z.files) == sorted(want)
        for k, v in want.items():
            assert z[k].dtype == np.float32
            np.testing.assert_array_equal(z[k], v)
    assert sum(v.size for v in want.values()) == 389_952
    for c in (1, 3, 6):
        for got, (w, _) in zip(randconv_kernels(c), _randconv_params(c)):
            np.testing.assert_array_equal(got, np.asarray(w))


@pytest.mark.parametrize("size", [7, 8, 33])
def test_same_padding_matches_xla(size):
    """A stride-2 3x3 conv padded by `same_padding` equals XLA's "SAME"
    conv in fp32 (1e-5), at odd and even sizes; at an even size
    Conv2d(padding=1) shifts every output and does not."""
    x = _images(2, size, 4, seed=2)
    w = np.random.default_rng(3).standard_normal((3, 3, 4, 5)).astype(
        np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), window_strides=(2, 2),
        padding="SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    wt = torch.from_numpy(w).permute(3, 2, 0, 1)
    pad = same_padding(size)
    assert pad == ((0, 1) if size % 2 == 0 else (1, 1))
    got = F.conv2d(F.pad(xt, (*pad, *pad)), wt, stride=2).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    naive = F.conv2d(xt, wt, stride=2, padding=1).permute(0, 2, 3, 1)
    assert naive.shape == want.shape
    assert (size % 2 == 1) == np.allclose(naive.numpy(), want, atol=1e-5)


def _run(fn, args):
    out = []
    return fn(args, log=out.append), out


def test_cli_dir_vs_dir_and_stats_cache_match_sdm_tpu(tmp_path):
    """Two directories of 12 images (one 16x16 image among the real ones,
    area-resized to the first size): both packages' CLIs give the same
    FID and KID on pixel features (1e-6 relative); a set against itself
    reads 0; the real stats cache is written, reused without --real-path,
    and refused for other features; --out holds the printed JSON."""
    real = _write_images(tmp_path / "real", 12, 8, 0)
    cv2.imwrite(os.path.join(real, "odd.png"), np.full((16, 16, 3), 90,
                                                       np.uint8))
    gen = _write_images(tmp_path / "gen", 12, 8, 1)
    common = ["--real-path", real, "--gen-path", gen, "--features", "pixel:4",
              "--kid-block-size", "6"]
    got, _ = _run(evaluate_samples, common + ["--device", "cpu", "--out",
                                              str(tmp_path / "m.json")])
    want, _ = _run(jax_evaluate, common)
    assert got["n_real"] == 13 and got["n_generated"] == 12
    for key in ("fid", "kid", "kid_std"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6)
    assert json.loads((tmp_path / "m.json").read_text()) == got
    same, _ = _run(evaluate_samples, ["--real-path", gen, "--gen-path", gen,
                                      "--features", "pixel:4", "--metrics",
                                      "fid", "--device", "cpu"])
    assert same["fid"] < FID_TOL

    stats = str(tmp_path / "real_stats.npz")
    first, _ = _run(evaluate_samples, common[:4] + [
        "--features", "pixel:4", "--metrics", "fid", "--real-stats", stats,
        "--device", "cpu"])
    assert os.path.exists(stats)
    again, logged = _run(evaluate_samples, [
        "--gen-path", gen, "--features", "pixel:4", "--metrics", "fid",
        "--real-stats", stats, "--device", "cpu"])
    assert any("cached stats (13 images)" in line for line in logged)
    assert again["fid"] == first["fid"] == pytest.approx(got["fid"])
    with pytest.raises(ValueError, match="was built with features pixel:4"):
        evaluate_samples(["--gen-path", gen, "--features", "pixel:2",
                          "--metrics", "fid", "--real-stats", stats,
                          "--device", "cpu"], log=lambda *a: None)


def test_cli_samples_an_exported_bundle(tmp_path):
    """--gen-config samples a tiny exported bundle through the port's
    generator in two chunks on the CPU, writes the grid, and scores the 4
    images against a real directory; the flags default to CUDA."""
    torch.manual_seed(0)
    cfg = dict(in_channel=3, out_channel=3, num_layers=1,
               num_resnet_block=1, attn_layers=[0], attn_heads=1,
               attn_dim_per_head=None, time_dim=8, cond_dim=None,
               min_channel=32, max_channel=32, img_recon=False,
               noise_scheduler="LINEAR", beta1=5e-3, betaT=9e-3,
               min_noise_step=1, max_noise_step=10)
    ckpt = str(tmp_path / "m.pt")
    torch.save({"model": UNet.from_config(cfg).state_dict()}, ckpt)
    bundle = export_bundle("tiny", str(tmp_path), img_c=3, img_h=8, img_w=8,
                           model_type="BASE", entries=[(cfg, ckpt)])
    real = _write_images(tmp_path / "real", 6, 8, 0)
    grid = str(tmp_path / "grid" / "g.jpg")
    res, logged = _run(evaluate_samples, [
        "--real-path", real, "--gen-config",
        os.path.join(bundle, "config.json"), "-n", "4", "--gen-batch", "2",
        "--gen-args", "--diff_alg ddim --ddim_step_size 5",
        "--features", "pixel:4", "--save-gen-grid", grid, "--device", "cpu"])
    assert res["n_generated"] == 4 and res["n_real"] == 6
    assert np.isfinite(res["fid"]) and np.isfinite(res["kid"])
    assert sum("sampling chunk" in str(line) for line in logged) == 2
    assert cv2.imread(grid).shape == (2 + 8 + 2, 4 * 10 + 2, 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            evaluate_samples(["--real-path", real, "--gen-path", real],
                             log=lambda *a: None)
