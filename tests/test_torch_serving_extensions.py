"""The port's engine with the sampler extensions against sdm_tpu's on the
exported bundles of test_torch_serving.py (and a label-conditional and a
v-objective bundle of its own): dpmpp, heun, Karras spacing (also on cold
bundles), v-bundles and guidance give the same images for the same noise,
the extensions are refused message for message, and fp32 bundles run no
kernel.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdm_tpu.io.checkpoint import diffusion_checkpoint_dict
from sdm_tpu.models import UNet as JaxUNet
from sdm_tpu_torch.cli.export_models import export_bundle
from sdm_tpu_torch.serving import SamplerEngine
from test_torch_serving import (T, TRAJ_TOL, _jax, _jax_noise, _params,
                                _port, _train_cfg, bundle, cold_bundle)


def _params_cond(seed, cond_dim):
    net = JaxUNet(num_resnet_blocks=1, in_channel=3, out_channel=3,
                  time_dim=16, cond_dim=cond_dim, num_layers=2,
                  attn_layers=(1,), min_channel=32, max_channel=64,
                  use_pallas=False)
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, 16, 16, 3)),
                      jnp.array([1]), jnp.zeros((1, cond_dim)))["params"]
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def cond_bundle(tmp_path_factory):
    """One label-conditional BASE model (cond_dim 2) over steps 1..T."""
    tmp = tmp_path_factory.mktemp("port_cond_bundle")
    path = str(tmp / "cond.pt")
    torch.save(diffusion_checkpoint_dict(_params_cond(5, 2)), path)
    out = export_bundle("cond", str(tmp), img_c=3, img_h=16, img_w=16,
                        model_type="BASE",
                        entries=[(_train_cfg(1, T, cond_dim=2), path)])
    return os.path.join(out, "config.json")


@pytest.fixture(scope="module")
def v_bundle(tmp_path_factory):
    """The two-model ensemble's weights exported from a training config
    with "objective": "V": a bundle of v-models."""
    tmp = tmp_path_factory.mktemp("port_v_bundle")
    p1, p2 = str(tmp / "v1.pt"), str(tmp / "v2.pt")
    torch.save(diffusion_checkpoint_dict(_params(6)), p1)
    torch.save(diffusion_checkpoint_dict(_params(7)), p2)
    out = export_bundle("vpair", str(tmp), img_c=3, img_h=16, img_w=16,
                        model_type="BASE",
                        entries=[(_train_cfg(11, T, objective="V"), p1),
                                 (_train_cfg(1, 10, objective="V"), p2)])
    return os.path.join(out, "config.json")


LABELS = [0.5, -1.0]


@pytest.mark.parametrize("which,kw", [
    ("bundle", dict(diff_alg="dpmpp")), ("bundle", dict(diff_alg="heun")),
    ("cond", dict(guidance=True)), ("bundle", dict(karras=True)),
    ("bundle", dict(diff_alg="dpmpp", karras=True)),
    ("bundle", dict(diff_alg="heun", karras=True)),
    ("cold", dict(diff_alg="cold", karras=True)),
    ("v", dict(diff_alg="dpmpp")), ("v", dict(diff_alg="ddim")),
    ("cond", dict(guidance=True, diff_alg="dpmpp", karras=True))])
def test_port_engine_extensions_match_sdm_tpu(bundle, cond_bundle,
                                              cold_bundle, v_bundle,
                                              monkeypatch, which, kw):
    """dpmpp, heun, karras spacing (also on cold bundles), v-bundles and
    guidance (scale 3 at full batch; scales 3 and 1 over the coalesced
    path): the port's engine against sdm_tpu's with the same noise."""
    monkeypatch.setattr(SamplerEngine, "_noise_for", _jax_noise)
    cfg = dict(bundle=bundle, cond=cond_bundle, cold=cold_bundle,
               v=v_bundle)[which]
    port, ref = _port(cfg, **kw), _jax(cfg, **kw)
    labels = LABELS if which == "cond" else None
    gs = 3.0 if kw.get("guidance") else 1.0
    np.testing.assert_allclose(
        port.generate(4, seed=7, labels=labels, guidance_scale=gs),
        ref.generate(4, seed=7, labels=labels, guidance_scale=gs),
        **TRAJ_TOL)
    for scale in ((gs, 1.0) if kw.get("guidance") else (gs,)):
        reqs = [dict(num_images=2, seed=3, labels=labels,
                     guidance_scale=scale),
                dict(num_images=1, seed=9, labels=labels,
                     guidance_scale=scale)]
        for a, b in zip(port.generate_batch(reqs), ref.generate_batch(reqs)):
            np.testing.assert_allclose(a, b, **TRAJ_TOL)


def test_port_engine_extension_validation(bundle, cond_bundle, cold_bundle):
    """sdm_tpu's refusals of the extensions, message for message."""
    cases = [(bundle, dict(diff_alg="ddpm", karras=True)),
             (bundle, dict(guidance=True)),
             (cold_bundle, dict(diff_alg="cold", guidance=True))]
    for cfg, kw in cases:
        with pytest.raises(ValueError) as ours:
            _port(cfg, **kw)
        with pytest.raises(ValueError) as theirs:
            _jax(cfg, **kw)
        assert str(ours.value) == str(theirs.value), kw
    eng = _port(cond_bundle, guidance=True)
    with pytest.raises(ValueError, match="share guidance_scale"):
        eng.generate_batch([dict(num_images=1, labels=LABELS,
                                 guidance_scale=2.0),
                            dict(num_images=1, labels=LABELS,
                                 guidance_scale=3.0)])


@pytest.mark.parametrize("dtype,on", [(None, False),
                                      (torch.bfloat16, True)])
def test_fp32_bundles_run_no_kernel(bundle, v_bundle, dtype, on):
    """build_model_from_bundle: kernels off on every AdaGN and attention
    layer at fp32 (sdm_tpu/io/bundles.py:101-110), on with a compute dtype;
    a v-bundle's U-Net carries the samplers' v tag."""
    from sdm_tpu_torch.io.bundles import (build_model_from_bundle,
                                          load_bundle_config)
    from sdm_tpu_torch.models.layers import AdaGN, AttentionBlock
    for cfg, tag in ((bundle, "eps"), (v_bundle, "v")):
        models, folder = load_bundle_config(cfg)
        net, _ = build_model_from_bundle(models["models"][0], folder,
                                         max_T=T, device="cpu", dtype=dtype)
        layers = [m for m in net.modules()
                  if isinstance(m, (AdaGN, AttentionBlock))]
        assert sum(isinstance(m, AttentionBlock) for m in layers) == 2
        flags = [m.group_norm.use_kernels if isinstance(m, AdaGN)
                 else m.use_kernels for m in layers]
        assert flags == [on] * len(layers)
        assert getattr(net, "model_output", "eps") == tag
