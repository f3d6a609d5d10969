"""The cascade's second stage in the port: SR bundles served and generated
by sdm_tpu_torch against sdm_tpu, on CPU at a small size.

A tiny SR U-Net (6 input channels: the noisy image and the q-sampled
upsampled LR image; tanh out) with sdm_tpu's own init weights goes through
the port's export, both engines, the port's HTTP server and both SR
generators, with the noise injected so both sides see the same draws.
"""

import base64
import json
import os
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdm_tpu.cli.export_models import export_bundle as jax_export_bundle
from sdm_tpu.cli.generate_sr_images_diffusion import \
    generate_sr_images_diffusion as jax_generate_sr
from sdm_tpu.io.checkpoint import diffusion_checkpoint_dict
from sdm_tpu.models import UNet as JaxUNet
from sdm_tpu.ops.resize import area_resize as jax_area_resize
from sdm_tpu.serving import SamplerEngine as JaxEngine
from sdm_tpu_torch.cli.export_models import export_bundle
from sdm_tpu_torch.cli.generate_sr_images_diffusion import \
    generate_sr_images_diffusion
from sdm_tpu_torch.io.bundles import build_model_from_bundle
from sdm_tpu_torch.io.interop import params_to_state_dict
from sdm_tpu_torch.models import UNet
from sdm_tpu_torch.ops.resize import area_resize
from sdm_tpu_torch.serving import SamplerEngine

# Whole cold trajectories through the U-Net, fp32 in another order.
TRAJ_TOL = dict(atol=1e-4, rtol=1e-3)
FP32 = dict(atol=2e-5, rtol=2e-4)
T = 20
IMG = 16
COND_T = 5
SR_MODEL = dict(in_channel=6, out_channel=3, num_layers=2, num_resnet_block=1,
                attn_layers=[1], attn_heads=1, attn_dim_per_head=None,
                time_dim=16, cond_dim=None, min_channel=32, max_channel=64,
                img_recon=True)


def _sr_params(seed):
    net = JaxUNet(num_resnet_blocks=1, in_channel=6, out_channel=3,
                  time_dim=16, num_layers=2, attn_layers=(1,), min_channel=32,
                  max_channel=64, image_recon=True, use_pallas=False)
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, IMG, IMG, 6)),
                      jnp.array([1]))["params"]
    return net, jax.tree.map(np.asarray, params)


def _train_cfg(min_noise, max_noise):
    return dict(SR_MODEL, min_noise_step=min_noise, max_noise_step=max_noise,
                noise_scheduler="LINEAR", beta1=5e-3, betaT=9e-3,
                cond_t=COND_T)


@pytest.fixture(scope="module")
def sr_bundle(tmp_path_factory):
    """A two-entry SR ensemble (steps 20..11, then 10..1), exported by the
    port from sdm_tpu checkpoints."""
    tmp = tmp_path_factory.mktemp("sr_bundle")
    paths = []
    for i in range(2):
        p = str(tmp / f"sr{i}.pt")
        torch.save(diffusion_checkpoint_dict(_sr_params(10 + i)[1]), p)
        paths.append(p)
    out = export_bundle("sr", str(tmp), img_c=3, img_h=IMG, img_w=IMG,
                        model_type="SR",
                        entries=[(_train_cfg(11, T), paths[0]),
                                 (_train_cfg(1, 10), paths[1])])
    return os.path.join(out, "config.json")


def _jax_noise(self, seed, n):
    h, w, c = self.img_shape
    _, nk = jax.random.split(jax.random.PRNGKey(seed))
    return torch.from_numpy(np.asarray(
        jax.random.normal(nk, (n, h, w, c), jnp.float32)).copy())


def _lr(seed, h, w):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (h, w, 3)).astype(np.float32)


# ------------------------------------------------------------ area resize

@pytest.mark.parametrize("src,dst", [((8, 8), (3, 3)), ((5, 5), (8, 8)),
                                     ((16, 16), (32, 32)), ((8, 5), (3, 16)),
                                     ((7, 9), (7, 9))])
def test_area_resize_matches_sdm_tpu(src, dst):
    """Down and up, integer and non-integer ratios, one axis each way."""
    x = np.random.default_rng(0).standard_normal(
        (2, *src, 3)).astype(np.float32)
    ref = jax_area_resize(jnp.asarray(x), *dst)
    ours = area_resize(torch.from_numpy(x), *dst)
    assert ours.shape == (2, *dst, 3) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **FP32)


def test_area_resize_is_torch_area_interpolation():
    x = np.random.default_rng(1).standard_normal((1, 5, 7, 3)).astype(
        np.float32)
    want = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), size=(3, 11), mode="area")
    got = area_resize(torch.from_numpy(x), 3, 11).permute(0, 3, 1, 2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


# --------------------------------------------------- weights and bundles

def test_sr_unet_weights_carry_across():
    """A sdm_tpu SR U-Net (6-channel input conv, tanh out) carried to the
    port by params_to_state_dict: one forward call of both agrees."""
    net_j, params = _sr_params(3)
    net_t = UNet.from_config(SR_MODEL)
    net_t.load_state_dict(params_to_state_dict(params), strict=True)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, IMG, IMG, 6)).astype(np.float32)
    t = np.array([9, 2], np.int32)
    ref = net_j.apply({"params": params}, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        ours = net_t.eval()(torch.from_numpy(x), torch.from_numpy(t))
    assert ours.shape == (2, IMG, IMG, 3) and float(ours.abs().max()) <= 1
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-3)


@pytest.mark.parametrize("model_type", ["SR", "BASE-COLD"])
def test_bundles_export_as_sdm_tpu_and_load_strictly(tmp_path, model_type):
    """The port writes SR (cond_t) and BASE-COLD bundle entries key for key
    as sdm_tpu does, and loads each checkpoint strictly."""
    p = str(tmp_path / "m.pt")
    torch.save(diffusion_checkpoint_dict(_sr_params(5)[1]), p)
    cfg = _train_cfg(1, T)
    if model_type == "BASE-COLD":
        cfg.pop("cond_t")
    configs = []
    for name, fn in (("port", export_bundle), ("jax", jax_export_bundle)):
        out = fn(name, str(tmp_path / name), img_c=3, img_h=IMG, img_w=IMG,
                 model_type=model_type, entries=[(cfg, p)])
        with open(os.path.join(out, "config.json")) as f:
            configs.append(json.load(f))
        folder = out
    entry = configs[0]["models"][0]
    configs[0]["models"][0]["model_name"] = "x"
    configs[1]["models"][0]["model_name"] = "x"
    assert configs[0] == configs[1]
    assert ("cond_t" in entry) == (model_type == "SR")
    assert "beta_1" in entry and entry["in_channel"] == 6
    entry["model_name"] = f"jax_1-{T}.pt"
    net, schedule = build_model_from_bundle(entry, folder, max_T=T,
                                            device="cpu")
    assert net.image_recon and schedule.max_noise_step == T


# ------------------------------------------------------------- engines

def _engines(cfg, **kw):
    kw = dict(dict(step_size=4, max_T=T, max_batch=4), **kw)
    port = SamplerEngine(cfg, device="cpu", log=lambda *a, **k: None, **kw)
    ref = JaxEngine(cfg, log=lambda *a, **k: None, **kw)
    return port, ref


def test_sr_engine_matches_sdm_tpu_engine(sr_bundle, monkeypatch):
    """Full batch and coalesced requests whose LR images have different
    sizes (8x8 and a non-integer 5x7 ratio): upsample + delta, the shared
    noise, cond built once from the first entry, the re-degrade chain."""
    monkeypatch.setattr(SamplerEngine, "_noise_for", _jax_noise)
    port, ref = _engines(sr_bundle)
    assert port.kind == ref.kind == "sr" and port.diff_alg == "cold"
    lr = _lr(0, 8, 8)
    ours = port.generate(4, seed=7, lr_image=lr)
    assert ours.shape == (4, IMG, IMG, 3) and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref.generate(4, seed=7, lr_image=lr),
                               **TRAJ_TOL)
    reqs = [dict(num_images=2, seed=3, lr_image=_lr(1, 8, 8)),
            dict(num_images=1, seed=9, lr_image=_lr(2, 5, 7))]
    for a, b in zip(port.generate_batch(reqs), ref.generate_batch(reqs)):
        np.testing.assert_allclose(a, b, **TRAJ_TOL)


def test_sr_engine_coalesced_equals_alone_and_validates(sr_bundle):
    eng = SamplerEngine(sr_bundle, step_size=4, max_T=T, max_batch=4,
                        device="cpu", log=lambda *a, **k: None)
    eng.precompile()
    lr = _lr(3, 6, 6)
    alone = eng.generate(2, seed=5, lr_image=lr)
    mixed = eng.generate_batch([dict(num_images=1, seed=8,
                                     lr_image=_lr(4, 8, 8)),
                                dict(num_images=2, seed=5, lr_image=lr)])
    np.testing.assert_allclose(mixed[1], alone, rtol=0, atol=1e-6)
    for bad in (None, np.zeros((8, 8), np.float32),
                np.zeros((8, 8, 4), np.float32),
                np.zeros((IMG + 1, 8, 3), np.float32)):
        with pytest.raises(ValueError, match="lr_image"):
            eng.generate(1, lr_image=bad)


# ---------------------------------------------------------------- HTTP

def _post(url, payload, timeout=300):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _lr_payload(lr, **kw):
    return dict(kw, lr_image_b64=base64.b64encode(lr.tobytes()).decode(),
                lr_shape=list(lr.shape), format="npy")


def test_sr_server_over_http(sr_bundle):
    """Raw-float LR images (no OpenCV): the images equal the engine's, two
    concurrent requests coalesce, and bad LR payloads are refused."""
    from sdm_tpu_torch.cli.serve_diffusion import serve_diffusion
    server = serve_diffusion(
        ["-c", sr_bundle, "--port", "0", "--cold_step_size", "4", "-T",
         str(T), "--max-batch", "4", "--batch-wait-ms", "300", "--device",
         "cpu"], log=lambda *a, **k: None, block=False)
    url = f"http://{server.host}:{server.port}/generate"

    def images(resp):
        return np.frombuffer(base64.b64decode(resp["data_b64"]),
                             np.float32).reshape(resp["shape"])

    try:
        lr = _lr(5, 8, 8)
        alone = images(_post(url, _lr_payload(lr, num_images=2, seed=4)))
        np.testing.assert_allclose(
            alone, server.engine.generate(2, seed=4, lr_image=lr), rtol=0,
            atol=1e-6)
        got = {}

        def worker(i, n, img):
            got[i] = images(_post(url, _lr_payload(img, num_images=n,
                                                   seed=4 + 5 * i)))

        threads = [threading.Thread(target=worker, args=(0, 2, lr)),
                   threading.Thread(target=worker,
                                    args=(1, 1, _lr(6, 4, 6)))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
            assert not th.is_alive()
        np.testing.assert_allclose(got[0], alone, rtol=0, atol=1e-6)
        assert got[1].shape == (1, IMG, IMG, 3)

        good = _lr_payload(lr)
        bad_payloads = [
            dict(num_images=1),                              # no LR image
            dict(good, lr_shape=[8, 8]),                     # rank 2
            dict(good, lr_shape=[8, 4, 3]),                  # size mismatch
            _lr_payload(np.zeros((8, 8, 4), np.float32)),    # 4 channels
            _lr_payload(np.zeros((IMG * 2, 4, 3), np.float32)),  # too tall
            dict(good, lr_image_b64="%%%")]                  # not base64
        for bad in bad_payloads:
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(url, bad)
            assert e.value.code == 400
    finally:
        server.stop()


# ----------------------------------------------------------- generators

def test_sr_generator_matches_sdm_tpu(sr_bundle):
    """The SR generator on a numpy LR image (a batch of two), with the noise
    sdm_tpu's generator draws from the same seed handed to the port."""
    rng = np.random.default_rng(7)
    lr_u8 = rng.integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    seed = 11
    _, nk = jax.random.split(jax.random.PRNGKey(seed))
    noise = np.asarray(jax.random.normal(nk, (2, IMG, IMG, 3), jnp.float32))
    args = ["-c", sr_bundle, "--cold_step_size", "4", "-T", str(T), "-s",
            str(seed), "--device", "cpu"]
    quiet = dict(log=lambda *a, **k: None, save_locally=False)
    ref = jax_generate_sr(args, lr_img=lr_u8, **quiet)
    ours = generate_sr_images_diffusion(args, lr_img=lr_u8, noise=noise,
                                        **quiet)
    assert ours.shape == (2, IMG, IMG, 3)
    np.testing.assert_allclose(ours, np.asarray(ref), **TRAJ_TOL)


def test_sr_generator_validation(sr_bundle, tmp_path):
    quiet = dict(log=lambda *a, **k: None, save_locally=False)
    base = ["-c", sr_bundle, "-T", str(T), "--device", "cpu"]
    with pytest.raises(ValueError, match="low resolution"):
        generate_sr_images_diffusion(base, **quiet)          # no image
    with pytest.raises(ValueError, match="low resolution"):
        generate_sr_images_diffusion(base, lr_img=[[1]], **quiet)
    with pytest.raises(ValueError, match="Invalid shapes"):
        generate_sr_images_diffusion(
            base, lr_img=np.zeros((IMG * 2, IMG * 2, 3), np.uint8), **quiet)
    with pytest.raises(ValueError, match="step size"):
        generate_sr_images_diffusion(base + ["--cold_step_size", "50"],
                                     lr_img=np.zeros((8, 8, 3), np.uint8),
                                     **quiet)
    not_img = tmp_path / "x.png"
    not_img.write_bytes(b"not an image")
    with pytest.raises(ValueError, match="low resolution"):
        generate_sr_images_diffusion(base + ["--lr_img_path", str(not_img)],
                                     **quiet)
