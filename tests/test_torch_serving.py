"""The slice as a whole: one exported bundle served by sdm_tpu's
SamplerEngine and by the port's (device="cpu") gives the same images, and
the port's engine and HTTP server keep sdm_tpu's serving contract. The
sampler extensions on these bundles are held in
test_torch_serving_extensions.py (a file of its own, so that the two run
on separate workers).

The port draws a request's initial noise in one method, `_noise_for`; the
parity tests replace it with the JAX draw
`normal(split(PRNGKey(seed))[1], ...)` that sdm_tpu's engine makes."""

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

from sdm_tpu.cli.generate_images_cold_diffusion import \
    generate_images_cold_diffusion as jax_generate_cold
from sdm_tpu.io.checkpoint import diffusion_checkpoint_dict
from sdm_tpu.models import UNet as JaxUNet
from sdm_tpu.serving import SamplerEngine as JaxEngine
from sdm_tpu_torch.cli.export_models import export_bundle
from sdm_tpu_torch.cli.generate_images_cold_diffusion import \
    generate_images_cold_diffusion
from sdm_tpu_torch.serving import SamplerEngine
from sdm_tpu_torch.serving import engine as engine_mod

# Whole DDIM trajectories through the U-Net, fp32 in another order.
TRAJ_TOL = dict(atol=1e-4, rtol=1e-3)
T = 20
MODEL = dict(in_channel=3, out_channel=3, num_layers=2, num_resnet_block=1,
             attn_layers=[1], attn_heads=1, attn_dim_per_head=None,
             time_dim=16, cond_dim=None, min_channel=32, max_channel=64,
             img_recon=False)


def _train_cfg(min_noise, max_noise, **over):
    return dict(MODEL, min_noise_step=min_noise, max_noise_step=max_noise,
                noise_scheduler="LINEAR", beta1=5e-3, betaT=9e-3, **over)


def _params(seed, image_recon=False):
    net = JaxUNet(num_resnet_blocks=1, in_channel=3, out_channel=3,
                  time_dim=16, num_layers=2, attn_layers=(1,),
                  min_channel=32, max_channel=64, image_recon=image_recon,
                  use_pallas=False)
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, 16, 16, 3)),
                      jnp.array([1]))["params"]
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """A two-model BASE ensemble (steps 20..11 then 10..1), written by the
    port's export_bundle from sdm_tpu checkpoints; entry 1 also carries
    "ema" weights."""
    tmp = tmp_path_factory.mktemp("port_bundle")
    p1, p2 = str(tmp / "a.pt"), str(tmp / "b.pt")
    torch.save(diffusion_checkpoint_dict(_params(0), ema_params=_params(2)),
               p1)
    torch.save(diffusion_checkpoint_dict(_params(1)), p2)
    out = export_bundle("pair", str(tmp), img_c=3, img_h=16, img_w=16,
                        model_type="BASE",
                        entries=[(_train_cfg(11, T), p1),
                                 (_train_cfg(1, 10), p2)])
    return os.path.join(out, "config.json")


@pytest.fixture(scope="module")
def cold_bundle(tmp_path_factory):
    """A two-model BASE-COLD ensemble of x0-predicting (tanh) U-Nets."""
    tmp = tmp_path_factory.mktemp("port_cold_bundle")
    p1, p2 = str(tmp / "c1.pt"), str(tmp / "c2.pt")
    torch.save(diffusion_checkpoint_dict(_params(3, True)), p1)
    torch.save(diffusion_checkpoint_dict(_params(4, True)), p2)
    out = export_bundle("cold", str(tmp), img_c=3, img_h=16, img_w=16,
                        model_type="BASE-COLD",
                        entries=[(_train_cfg(11, T, img_recon=True), p1),
                                 (_train_cfg(1, 10, img_recon=True), p2)])
    return os.path.join(out, "config.json")


def _jax_noise(self, seed, n):
    h, w, c = self.img_shape
    _, nk = jax.random.split(jax.random.PRNGKey(seed))
    return torch.from_numpy(np.asarray(
        jax.random.normal(nk, (n, h, w, c), jnp.float32)).copy())


def _port(cfg, **kw):
    kw.setdefault("diff_alg", "ddim")
    kw.setdefault("step_size", 4)
    kw.setdefault("max_T", T)
    kw.setdefault("max_batch", 4)
    return SamplerEngine(cfg, device="cpu", log=lambda *a, **k: None, **kw)


def _jax(cfg, **kw):
    kw.setdefault("diff_alg", "ddim")
    kw.setdefault("step_size", 4)
    kw.setdefault("max_T", T)
    kw.setdefault("max_batch", 4)
    return JaxEngine(cfg, log=lambda *a, **k: None, **kw)


def test_port_engine_matches_sdm_tpu_engine(bundle, monkeypatch):
    """Full batch (sdm_tpu's fused path) and a coalesced pair of requests
    (its flexible path), DDIM through a two-model ensemble."""
    monkeypatch.setattr(SamplerEngine, "_noise_for", _jax_noise)
    port, ref = _port(bundle), _jax(bundle)
    np.testing.assert_allclose(port.generate(4, seed=7),
                               ref.generate(4, seed=7), **TRAJ_TOL)
    reqs = [dict(num_images=2, seed=3), dict(num_images=1, seed=9)]
    for a, b in zip(port.generate_batch(reqs), ref.generate_batch(reqs)):
        np.testing.assert_allclose(a, b, **TRAJ_TOL)


def test_port_engine_use_ema_needs_ema_weights(bundle):
    """Entry 2 of the bundle has no "ema" weights: refused, as sdm_tpu
    refuses it."""
    with pytest.raises(ValueError, match="no 'ema'"):
        _port(bundle, use_ema=True)


def test_port_engine_coalescing_is_seed_deterministic(bundle):
    eng = _port(bundle)
    alone = eng.generate(2, seed=5)
    mixed = eng.generate_batch([dict(num_images=1, seed=8),
                                dict(num_images=2, seed=5)])
    np.testing.assert_allclose(mixed[1], alone, rtol=0, atol=1e-6)
    assert eng.stats.snapshot()["batches"] == 2


def test_port_engine_uint8_pipelined_and_stats(bundle):
    eng = _port(bundle, output_dtype="uint8")
    eng.precompile()
    assert eng.stats.snapshot()["batches"] == 0
    batches = [[dict(num_images=1, seed=s)] for s in range(3)]
    piped = eng.generate_pipelined(batches, depth=2)
    seq = [eng.generate_batch(b) for b in batches]
    for a, b in zip(piped, seq):
        assert a[0].dtype == np.uint8
        np.testing.assert_array_equal(a[0], b[0])
    f32 = _port(bundle).generate(1, seed=0)
    np.testing.assert_array_equal(
        piped[0][0], np.clip((f32 + 1.0) * 127.5, 0, 255).astype(np.uint8))
    assert eng.stats.snapshot()["images"] == 6


def test_port_engine_ddpm_runs(bundle):
    eng = _port(bundle, diff_alg="ddpm")
    a, b = eng.generate(2, seed=1), eng.generate(2, seed=1)
    assert a.shape == (2, 16, 16, 3) and np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)


def test_port_engine_validation(bundle):
    eng = _port(bundle)
    with pytest.raises(ValueError, match="exceeds max_batch"):
        eng.generate(5)
    with pytest.raises(ValueError, match="guidance_scale"):
        eng.generate(1, guidance_scale=2.0)
    with pytest.raises(ValueError):
        _port(bundle, diff_alg="euler")
    with pytest.raises(ValueError):
        _port(bundle, output_dtype="float16")


@pytest.mark.parametrize("kw", [dict(num_devices=2)])
def test_port_engine_refuses_later_slices(bundle, kw, monkeypatch):
    """Data-parallel serving is ported (tests/test_torch_parallel.py); a
    count above the visible CUDA cards is refused before anything is
    built, naming the count, where sdm_tpu would slice its device list."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 devices asked for, 1 visible"):
        SamplerEngine(bundle, device="cuda", max_batch=4,
                      log=lambda *a, **k: None, **kw)


def test_port_engine_serves_cold_bundle_as_sdm_tpu(cold_bundle, monkeypatch):
    """diff_alg="cold" (once refused here): the shared initial noise and the
    re-degrade chain across the ensemble, at full batch and coalesced; the
    coalesced request equals the same request alone."""
    monkeypatch.setattr(SamplerEngine, "_noise_for", _jax_noise)
    port = _port(cold_bundle, diff_alg="cold")
    ref = _jax(cold_bundle, diff_alg="cold")
    assert port.kind == ref.kind == "cold"
    np.testing.assert_allclose(port.generate(4, seed=7),
                               ref.generate(4, seed=7), **TRAJ_TOL)
    reqs = [dict(num_images=2, seed=3), dict(num_images=1, seed=9)]
    got = port.generate_batch(reqs)
    for a, b in zip(got, ref.generate_batch(reqs)):
        np.testing.assert_allclose(a, b, **TRAJ_TOL)
    np.testing.assert_allclose(got[1], port.generate(1, seed=9), rtol=0,
                               atol=1e-6)


def test_port_cold_generator_matches_sdm_tpu(cold_bundle):
    """The cold generator with sdm_tpu's seed-drawn noise handed to the
    port; a reference-style bundle without beta_1/beta_T still runs."""
    seed = 12
    _, nk = jax.random.split(jax.random.PRNGKey(seed))
    noise = np.asarray(jax.random.normal(nk, (2, 16, 16, 3), jnp.float32))
    args = ["-c", cold_bundle, "-n", "2", "--cold_step_size", "4", "-T",
            str(T), "-s", str(seed), "--device", "cpu"]
    quiet = dict(log=lambda *a, **k: None, save_locally=False)
    ref = jax_generate_cold(args, **quiet)
    ours = generate_images_cold_diffusion(args, noise=noise, **quiet)
    assert ours.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(ours, np.asarray(ref), **TRAJ_TOL)
    with pytest.raises(ValueError, match="noise must be"):
        generate_images_cold_diffusion(args, noise=noise[:1], **quiet)


def test_port_cold_generator_karras_matches_sdm_tpu(cold_bundle):
    """--karras on the cold generator: the rho-7 list of as many steps."""
    seed = 13
    _, nk = jax.random.split(jax.random.PRNGKey(seed))
    noise = np.asarray(jax.random.normal(nk, (2, 16, 16, 3), jnp.float32))
    args = ["-c", cold_bundle, "-n", "2", "--cold_step_size", "3", "-T",
            str(T), "-s", str(seed), "--device", "cpu", "--karras"]
    quiet = dict(log=lambda *a, **k: None, save_locally=False)
    ref = jax_generate_cold(args, **quiet)
    ours = generate_images_cold_diffusion(args, noise=noise, **quiet)
    np.testing.assert_allclose(ours, np.asarray(ref), **TRAJ_TOL)
    uniform = generate_images_cold_diffusion(args[:-1], noise=noise,
                                             **quiet)
    assert not np.allclose(ours, uniform)


def test_port_engine_needs_cuda_unless_asked_for_cpu(bundle, monkeypatch):
    """device=None means the CUDA device: without one the engine raises
    instead of running on the CPU."""
    monkeypatch.setattr(engine_mod.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SamplerEngine(bundle, max_T=T, log=lambda *a, **k: None)
    assert engine_mod.resolve_device("cpu").type == "cpu"


# ------------------------------------------------------------------ HTTP

def _post(url, payload, timeout=300):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def test_port_server_over_http(bundle):
    from sdm_tpu_torch.cli.serve_diffusion import serve_diffusion
    server = serve_diffusion(
        ["-c", bundle, "--port", "0", "--ddim_step_size", "4", "-T", str(T),
         "--max-batch", "4", "--batch-wait-ms", "300", "--device", "cpu"],
        log=lambda *a, **k: None, block=False)
    base = f"http://{server.host}:{server.port}"
    try:
        health = _get(base + "/healthz")
        assert health["img_shape"] == [16, 16, 3]
        assert health["max_batch"] == 4

        def images(resp):
            return np.frombuffer(base64.b64decode(resp["data_b64"]),
                                 np.float32).reshape(resp["shape"])

        alone = images(_post(base + "/generate",
                             dict(num_images=1, seed=4)))
        got = {}

        def worker(i):
            got[i] = images(_post(base + "/generate",
                                  dict(num_images=1, seed=4 + i)))

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
            assert not th.is_alive()
        np.testing.assert_allclose(got[0], alone, rtol=0, atol=1e-6)
        stats = _get(base + "/stats")
        assert stats["requests_served"] == 4
        assert stats["batches"] < 4          # the three coalesced

        for bad in (dict(num_images=0), dict(num_images=9),
                    dict(format="gif"), dict(guidance_scale=2.0)):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(base + "/generate", bad)
            assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(base + "/nope")
        assert e.value.code == 404
    finally:
        server.stop()
