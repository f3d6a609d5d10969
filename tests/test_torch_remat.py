"""The U-Net's rematerialization (config "remat": sdm_tpu_torch/models/unet.py
and models/layers.py::UNetBlock) against the same U-Net without it and
against sdm_tpu's UNet(remat=True).

Small sizes (16x16 images, 2 layers, channels 32/64), fp32 on the CPU;
sdm_tpu's weights are carried across by the port's `params_to_state_dict`.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdm_tpu.models import UNet as JaxUNet
from sdm_tpu_torch.io.interop import params_to_state_dict
from sdm_tpu_torch.models import UNet
from sdm_tpu_torch.models.layers import (AdaGN, AttentionBlock,
                                         ResidualBlock, UNetConvBlock)

SMALL = dict(num_resnet_blocks=1, in_channel=3, out_channel=3, time_dim=16,
             num_layers=2, attn_layers=(1,), groups=32, min_channel=32,
             max_channel=64, cond_dim=None, num_heads=1, dim_per_head=None,
             image_recon=False)
# fp32 gradients of the same loss in two frameworks, each element against
# the largest gradient element (as test_torch_train_step.py holds a step).
GRAD_TOL = 2e-4


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    t = np.array([7, 3], np.int32)
    target = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    return x, t, target


def _port_grads(net, x, t, target):
    net.zero_grad(set_to_none=True)
    out = net(torch.from_numpy(x), torch.from_numpy(t))
    loss = torch.mean(torch.square(out - torch.from_numpy(target)))
    loss.backward()
    return loss.item(), {name: p.grad.clone()
                         for name, p in net.named_parameters()
                         if p.grad is not None}


@pytest.mark.parametrize("use_kernels", [True, False])
def test_remat_gradients_equal_the_plain_backward(use_kernels):
    """Remat replays the same forward, so on the CPU the loss and every
    gradient are bit-identical (tolerance 0), with the kernels' autograd
    Functions (their plain versions here) or without; the parameter names
    are the same, so one state_dict loads into both."""
    x, t, target = _inputs()
    torch.manual_seed(0)
    plain = UNet(**SMALL, use_kernels=use_kernels)
    remat = UNet(**SMALL, use_kernels=use_kernels, remat=True)
    assert list(remat.state_dict()) == list(plain.state_dict())
    remat.load_state_dict(plain.state_dict(), strict=True)
    loss_p, grads_p = _port_grads(plain, x, t, target)
    loss_r, grads_r = _port_grads(remat, x, t, target)
    assert loss_r == loss_p
    assert list(grads_r) == list(grads_p)
    for name, g in grads_r.items():
        torch.testing.assert_close(g, grads_p[name], rtol=0, atol=0)


def test_remat_replays_every_sublayer_in_the_backward():
    """Under remat the backward runs each residual and attention block
    twice more (the block's checkpoint replays it to reach the nested
    checkpoints' inputs, then each nested checkpoint replays its own), so a
    forward and backward runs AdaGN and the attention three times where
    the plain U-Net runs them once. Without a gradient nothing is
    checkpointed and nothing replays."""
    torch.manual_seed(0)
    net = UNet(**SMALL, remat=True)
    calls = collections.Counter()
    for m in net.modules():
        if isinstance(m, (AdaGN, AttentionBlock, ResidualBlock,
                          UNetConvBlock)):
            m.register_forward_pre_hook(
                lambda mod, args, n=type(m).__name__: calls.update([n]))
    x, t, target = _inputs()
    with torch.no_grad():
        net(torch.from_numpy(x), torch.from_numpy(t))
    once = dict(calls)
    assert once == {"UNetConvBlock": 14, "ResidualBlock": 4, "AdaGN": 8,
                    "AttentionBlock": 2}
    calls.clear()
    _port_grads(net, x, t, target)
    assert calls["AdaGN"] == 3 * once["AdaGN"]
    assert calls["AttentionBlock"] == 3 * once["AttentionBlock"]
    assert calls["ResidualBlock"] == 3 * once["ResidualBlock"]


def test_remat_gradients_match_sdm_tpu():
    """The port's remat U-Net against sdm_tpu's UNet(remat=True), the same
    weights and inputs: the loss, and each gradient element within
    GRAD_TOL of the largest."""
    x, t, target = _inputs(1)
    net_j = JaxUNet(**SMALL, use_pallas=False, remat=True)
    params = jax.jit(net_j.init)(jax.random.PRNGKey(1), jnp.asarray(x),
                                 jnp.asarray(t))["params"]

    def loss_fn(p):
        out = net_j.apply({"params": p}, jnp.asarray(x), jnp.asarray(t))
        return jnp.mean(jnp.square(out - jnp.asarray(target)))

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(params)
    grads_j = params_to_state_dict(jax.tree.map(np.asarray, grads_j))
    net_t = UNet(**SMALL, remat=True)
    net_t.load_state_dict(params_to_state_dict(
        jax.tree.map(np.asarray, params)), strict=True)
    loss_t, grads_t = _port_grads(net_t, x, t, target)
    np.testing.assert_allclose(loss_t, float(loss_j), rtol=1e-5)
    scale = max(float(g.abs().max()) for g in grads_j.values())
    for name, g in grads_t.items():
        np.testing.assert_allclose(g.numpy(), grads_j[name].numpy(),
                                   rtol=0, atol=GRAD_TOL * scale,
                                   err_msg=name)


def test_from_config_reads_remat():
    cfg = dict(in_channel=3, out_channel=3, num_layers=1, num_resnet_block=1,
               attn_layers=[0], attn_heads=1, attn_dim_per_head=None,
               time_dim=8, cond_dim=None, min_channel=32, max_channel=32)
    assert not UNet.from_config(cfg).remat
    net = UNet.from_config(dict(cfg, remat=True))
    assert net.remat and all(b.remat for b in net.down_layers)
