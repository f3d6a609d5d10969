"""The port's model stack (sdm_tpu_torch: ops, models, io) against sdm_tpu.

Weights come from sdm_tpu's own init, carried across by the port's
`params_to_state_dict` and loaded strictly; inputs are numpy draws handed to
both sides. Small sizes: 16x16 images, 2 layers, channels 32/64, groups 32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdm_tpu.io.checkpoint import diffusion_checkpoint_dict
from sdm_tpu.models import UNet as JaxUNet
from sdm_tpu.ops.norms import group_norm as jax_group_norm
from sdm_tpu.ops.schedules import make_schedule as jax_make_schedule
from sdm_tpu_torch.io.checkpoint import load_checkpoint, save_model
from sdm_tpu_torch.io.interop import params_to_state_dict
from sdm_tpu_torch.models import UNet
from sdm_tpu_torch.models.layers import AdaGN, AttentionBlock
from sdm_tpu_torch.ops.norms import group_norm
from sdm_tpu_torch.ops.schedules import make_schedule

# U-Net outputs after ~20 layers of fp32 arithmetic in another order.
UNET_TOL = dict(atol=1e-4, rtol=1e-3)
FP32 = dict(atol=2e-5, rtol=2e-4)

SMALL = dict(num_resnet_blocks=1, in_channel=3, out_channel=3, time_dim=16,
             num_layers=2, attn_layers=(1,), groups=32, min_channel=32,
             max_channel=64)


def _jax_unet(**kw):
    cfg = dict(SMALL, cond_dim=None, num_heads=1, dim_per_head=None,
               image_recon=False)
    cfg.update(kw)
    net = JaxUNet(**cfg, use_pallas=False)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    t = np.array([7, 3], np.int32)
    cond = (rng.standard_normal((2, cfg["cond_dim"])).astype(np.float32)
            if cfg["cond_dim"] else None)
    params = net.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(t),
                      None if cond is None else jnp.asarray(cond))["params"]
    return cfg, net, jax.tree.map(np.asarray, params), (x, t, cond)


def _port_unet(cfg, np_params, **kw):
    net = UNet(**cfg, **kw)
    net.load_state_dict(params_to_state_dict(np_params), strict=True)
    return net.eval()


def _run_both(net_j, params, net_t, x, t, cond):
    ref = net_j.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                      None if cond is None else jnp.asarray(cond))
    with torch.no_grad():
        ours = net_t(torch.from_numpy(x), torch.from_numpy(t),
                     None if cond is None else torch.from_numpy(cond))
    return np.asarray(ref), ours.float().numpy()


@pytest.mark.parametrize("cond_dim", [None, 2])
@pytest.mark.parametrize("parity", [True, False])
def test_unet_forward_matches_sdm_tpu(cond_dim, parity):
    cfg, net_j, params, (x, t, cond) = _jax_unet(cond_dim=cond_dim,
                                                 parity=parity)
    net_t = _port_unet(cfg, params)
    assert {m.parity for m in net_t.modules()
            if isinstance(m, (AdaGN, AttentionBlock))} == {parity}
    ref, ours = _run_both(net_j, params, net_t, x, t, cond)
    assert ours.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(ours, ref, **UNET_TOL)


def test_unet_multihead_matches_sdm_tpu():
    """heads > 1 goes through the attention dispatcher (fused_attention with
    use_kernels) instead of the block kernel."""
    cfg, net_j, params, (x, t, cond) = _jax_unet(num_heads=2,
                                                 dim_per_head=16)
    for use_kernels in (True, False):
        net_t = _port_unet(cfg, params, use_kernels=use_kernels)
        ref, ours = _run_both(net_j, params, net_t, x, t, cond)
        np.testing.assert_allclose(ours, ref, **UNET_TOL)


def test_unet_bf16_matches_sdm_tpu():
    """bf16 compute with bf16-stored weights, as the bf16 serving engine
    runs it. Rounding points match, but a last-bit difference in an fp32
    intermediate flips a bf16 rounding now and then and the flips travel
    through the net, so the bound is normwise: 3e-2 of the output."""
    cfg, net_j, params, (x, t, cond) = _jax_unet()
    net_jb = JaxUNet(**cfg, use_pallas=False, dtype=jnp.bfloat16)
    params_b = jax.tree.map(lambda p: jnp.asarray(p, jnp.bfloat16), params)
    net_t = _port_unet(cfg, params, dtype=torch.bfloat16).to(torch.bfloat16)
    ref, ours = _run_both(net_jb, params_b, net_t, x, t, cond)
    ref = ref.astype(np.float32)
    rel = np.linalg.norm(ours - ref) / np.linalg.norm(ref)
    assert rel < 3e-2, rel


def test_checkpoint_from_sdm_tpu_loads_strictly(tmp_path):
    """A {model, optimizer} checkpoint written by sdm_tpu loads into the
    port with strict=True (dead y_shift and attention norm included), and
    the port's save_model round-trips it."""
    cfg, net_j, params, (x, t, cond) = _jax_unet()
    path = tmp_path / "ckpt.pt"
    torch.save(diffusion_checkpoint_dict(params), path)
    ok, ckpt = load_checkpoint(str(path), log=lambda *a: None)
    assert ok and set(ckpt) == {"model"}
    net_t = UNet(**cfg)
    net_t.load_state_dict(ckpt["model"], strict=True)
    assert any(k.endswith("adagn.y_shift.weight") for k in ckpt["model"])
    assert any(k.endswith("attn_layers.0.norm.weight") for k in ckpt["model"])
    ref, ours = _run_both(net_j, params, net_t.eval(), x, t, cond)
    np.testing.assert_allclose(ours, ref, **UNET_TOL)

    assert save_model({"model": net_t.state_dict()}, "diffusion",
                      str(tmp_path), checkpoint=True, steps=5,
                      log=lambda *a: None)
    ok, again = load_checkpoint(str(tmp_path / "checkpoint" /
                                    "diffusion_5.pt"), log=lambda *a: None)
    assert ok
    for k, v in ckpt["model"].items():
        torch.testing.assert_close(again["model"][k], v, rtol=0, atol=0)


def test_load_checkpoint_missing_file(tmp_path):
    assert load_checkpoint(str(tmp_path / "nope.pt"),
                           log=lambda *a: None) == (False, None)


def test_unet_validation_matches_sdm_tpu():
    for kw, exc in ((dict(num_layers=0), ValueError),
                    (dict(attn_layers=(2,)), ValueError),
                    (dict(attn_layers=[1.0]), ValueError),
                    (dict(attn_layers=1), TypeError)):
        with pytest.raises(exc):
            JaxUNet(**dict(SMALL, **kw))
        with pytest.raises(exc):
            UNet(**dict(SMALL, **kw))


def test_from_config_matches_sdm_tpu():
    config = dict(in_channel=3, out_channel=3, num_layers=2,
                  num_resnet_block=1, attn_layers=[1], attn_heads=1,
                  attn_dim_per_head=None, time_dim=16, cond_dim=None,
                  min_channel=32, max_channel=64, image_recon=True)
    j, p = JaxUNet.from_config(config), UNet.from_config(config)
    assert p.image_recon and j.image_recon
    assert p.channel_schedule() == j.channel_schedule()


@pytest.mark.parametrize("name", ["LINEAR", "COSINE"])
def test_schedules_match_sdm_tpu(name):
    steps = np.array([1, 2, 10, 500, 999, 1000])
    js = jax_make_schedule(name, beta_1=5e-3, beta_T=9e-3,
                           max_noise_step=1000)
    ts = make_schedule(name, beta_1=5e-3, beta_T=9e-3, max_noise_step=1000)
    for a, b in zip(js.timestep_params(jnp.asarray(steps)),
                    ts.timestep_params(torch.from_numpy(steps))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **FP32)
    rng = np.random.default_rng(2)
    img = rng.standard_normal((6, 4, 4, 3)).astype(np.float32)
    eps = rng.standard_normal((6, 4, 4, 3)).astype(np.float32)
    ref = js.q_sample(jnp.asarray(img), jnp.asarray(steps), jnp.asarray(eps))
    ours = ts.q_sample(torch.from_numpy(img), torch.from_numpy(steps),
                       torch.from_numpy(eps))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **FP32)
    with pytest.raises(ValueError):
        make_schedule("QUADRATIC")


def test_group_norm_matches_sdm_tpu():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 5, 5, 64)) * 3 + 10).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    ref = jax_group_norm(jnp.asarray(x), jnp.asarray(scale),
                         jnp.asarray(bias), 32)
    ours = group_norm(*map(torch.from_numpy, (x, scale, bias)), 32)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **FP32)
    with pytest.raises(ValueError):
        group_norm(torch.zeros(1, 2, 2, 30), torch.ones(30), torch.zeros(30),
                   32)
