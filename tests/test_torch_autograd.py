"""Gradients through the port's kernel Functions against sdm_tpu's VJPs.

sdm_tpu's AdaGN, whole-S attention and attention-block kernels carry custom
VJPs that differentiate the XLA reference on the saved inputs. The port's
`FusedAdaGN`, `FusedAttention` and `FusedAttentionBlock` do the same with
the plain PyTorch version; here their gradients are held against `jax.grad`
through sdm_tpu's custom VJPs, with the forward in Pallas interpret mode.
Past `whole_s_ok` the block composes `Linear`, the streaming Function and
`Linear`, and its gradients must still equal sdm_tpu's block VJP. On the CPU
the Functions' forwards are the plain versions, so what is tested is the
backward math and the routing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdm_tpu.kernels.adagn import fused_adagn as jax_fused_adagn
from sdm_tpu.kernels.attention import fused_attention as jax_fused_attention
from sdm_tpu.kernels.attention_block import \
    fused_attention_block as jax_fused_attention_block
from sdm_tpu_torch.kernels import attention_block as port_block
from sdm_tpu_torch.kernels.adagn import fused_adagn
from sdm_tpu_torch.kernels.attention import fused_attention
from sdm_tpu_torch.kernels.attention_block import (fused_attention_block,
                                                   linear, linear_reference)

# fp32 gradients, port vs JAX on the CPU: the same math in another
# summation order. Relative to each gradient's largest element, because the
# query-axis softmax gradients cancel (their elements are differences of
# nearly equal sums).
RTOL, OF_MAX = 2e-4, 2e-5
QK_STD = 1.5
TOK_STD = 2.6


@pytest.fixture
def interpret(monkeypatch):
    from jax.experimental.pallas import tpu as pltpu
    monkeypatch.setenv("SDM_TPU_PALLAS_INTERPRET", "1")
    with pltpu.force_tpu_interpret_mode():
        yield


def _close(got, want):
    want = np.asarray(want, np.float32)
    got = got.detach().to(torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=OF_MAX * float(np.abs(want).max()))


def _jax_grads(fn, arrays, g):
    """Gradients of sum(fn(*arrays) * g) with respect to every array."""
    return jax.grad(lambda *a: jnp.sum(fn(*a) * g),
                    argnums=tuple(range(len(arrays))))(*arrays)


def _port_grads(fn, arrays, g):
    leaves = [torch.from_numpy(np.array(a)).requires_grad_() for a in arrays]
    out = fn(*leaves)
    out.backward(torch.from_numpy(np.asarray(g)))
    return out, [t.grad for t in leaves]


def test_adagn_function_grads_match_jax(interpret):
    """C = 128 takes the Pallas kernel in sdm_tpu; (N, C) FiLM tables, as a
    per-sample t gives in training."""
    rng = np.random.default_rng(0)
    n, h, w, c = 2, 8, 8, 128
    arrays = [(rng.standard_normal((n, h, w, c)) * 2.0 + 0.5),
              1.0 + 0.1 * rng.standard_normal(c), 0.1 * rng.standard_normal(c),
              1.0 + 0.5 * rng.standard_normal((n, c)),
              0.5 * rng.standard_normal((n, c))]
    arrays = [a.astype(np.float32) for a in arrays]
    g = rng.standard_normal((n, h, w, c)).astype(np.float32)
    want = _jax_grads(lambda *a: jax_fused_adagn(*a, 32, 1e-5),
                      [jnp.asarray(a) for a in arrays], g)
    out, got = _port_grads(lambda *a: fused_adagn(*a, 32), arrays, g)
    assert type(out.grad_fn).__name__ == "FusedAdaGNBackward"
    for gr, wa in zip(got, want):
        _close(gr, wa)


@pytest.mark.parametrize("axis", ["q", "k"])
def test_attention_function_grads_match_jax(interpret, axis):
    """(N, S, H, D) = (2, 128, 1, 128): sdm_tpu's whole-tile kernel."""
    rng = np.random.default_rng(1)
    shape = (2, 128, 1, 128)
    arrays = [(std * rng.standard_normal(shape)).astype(np.float32)
              for std in (QK_STD, QK_STD, 1.0)]
    g = rng.standard_normal(shape).astype(np.float32)
    scale = 128 ** -0.5
    want = _jax_grads(lambda *a: jax_fused_attention(*a, scale, axis),
                      [jnp.asarray(a) for a in arrays], g)
    out, got = _port_grads(lambda *a: fused_attention(*a, scale, axis),
                           arrays, g)
    assert type(out.grad_fn).__name__ == "FusedAttentionBackward"
    for gr, wa in zip(got, want):
        _close(gr, wa)


def _block_arrays(rng, n, s, c):
    bound = 1.0 / np.sqrt(c)
    return [(TOK_STD * rng.standard_normal((n, s, c))).astype(np.float32),
            rng.uniform(-bound, bound, (c, 3 * c)).astype(np.float32),
            rng.uniform(-bound, bound, 3 * c).astype(np.float32),
            rng.uniform(-bound, bound, (c, c)).astype(np.float32),
            rng.uniform(-bound, bound, c).astype(np.float32)]


def _block_case(axis, seed, s=128, c=128):
    """sdm_tpu's block VJP gradients (flax (in, out) kernels, turned to the
    port's (out, in) layout) and the port's inputs and upstream gradient."""
    rng = np.random.default_rng(seed)
    arrays = _block_arrays(rng, 2, s, c)
    g = rng.standard_normal((2, s, c)).astype(np.float32)
    scale = c ** -0.5
    want = list(_jax_grads(
        lambda *a: jax_fused_attention_block(*a, scale, axis),
        [jnp.asarray(a) for a in arrays], g))
    want[1], want[3] = np.asarray(want[1]).T, np.asarray(want[3]).T
    ports = [arrays[0], arrays[1].T, arrays[2], arrays[3].T, arrays[4]]
    return ports, g, want, scale


@pytest.mark.parametrize("axis", ["q", "k"])
def test_block_function_grads_match_jax(interpret, axis):
    ports, g, want, scale = _block_case(axis, 2)
    out, got = _port_grads(
        lambda *a: fused_attention_block(*a, scale, axis), ports, g)
    assert type(out.grad_fn).__name__ == "FusedAttentionBlockBackward"
    for gr, wa in zip(got, want):
        _close(gr, wa)


def _grad_fns(out):
    """Names of every node of the autograd graph behind `out`."""
    seen, stack, names = set(), [out.grad_fn], set()
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        stack.extend(nxt for nxt, _ in fn.next_functions)
    return names


@pytest.mark.parametrize("axis", ["q", "k"])
def test_block_past_whole_s_takes_the_streaming_function(interpret,
                                                         monkeypatch, axis):
    """With the whole-S predicate refusing, the block's gradient comes from
    Linear, the streaming Function (dV, dK, dQ passes) and Linear, and equals
    sdm_tpu's block VJP."""
    monkeypatch.setattr(port_block, "whole_s_ok", lambda *a: False)
    ports, g, want, scale = _block_case(axis, 3)
    out, got = _port_grads(
        lambda *a: fused_attention_block(*a, scale, axis), ports, g)
    names = _grad_fns(out)
    assert "StreamingAttentionBackward" in names
    assert "LinearBackward" in names
    assert "FusedAttentionBlockBackward" not in names
    for gr, wa in zip(got, want):
        _close(gr, wa)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linear_function_grads_match_autograd(dtype):
    """`Linear`'s hand-written backward equals autograd through
    `linear_reference`, residual included, at the inputs' dtypes."""
    rng = np.random.default_rng(4)
    x, w, b, r = (torch.from_numpy(rng.standard_normal(shape)
                                   .astype(np.float32))
                  for shape in ((6, 5), (4, 5), (4,), (6, 4)))
    x, w, r = (t.to(dtype) for t in (x, w, r))
    g = torch.from_numpy(rng.standard_normal((6, 4)).astype(np.float32)
                         ).to(dtype)
    grads = []
    for fn in (linear, linear_reference):
        leaves = [t.clone().requires_grad_() for t in (x, w, b, r)]
        out = fn(*leaves)
        out.backward(g)
        grads.append([t.grad for t in leaves])
        if fn is linear:
            assert type(out.grad_fn).__name__ == "LinearBackward"
    for got, want in zip(*grads):
        assert got.dtype == want.dtype
        torch.testing.assert_close(got.float(), want.float(), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("stream", [False, True])
def test_unet_grads_with_functions_match_plain_autograd(monkeypatch, stream):
    """A small U-Net with use_kernels=True (every Function, and the
    streaming one when the whole-S predicate refuses) against
    use_kernels=False (plain autograd): the same parameter gradients."""
    from sdm_tpu_torch.models import UNet
    if stream:
        monkeypatch.setattr(port_block, "whole_s_ok", lambda *a: False)
    cfg = dict(num_resnet_blocks=1, in_channel=6, out_channel=3, time_dim=8,
               num_layers=2, attn_layers=(1,), min_channel=32,
               max_channel=64, image_recon=True)
    torch.manual_seed(0)
    nets = [UNet(**cfg, use_kernels=True), UNet(**cfg, use_kernels=False)]
    nets[1].load_state_dict(nets[0].state_dict())
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 16, 16, 6))
                         .astype(np.float32))
    t = torch.tensor([3, 7])
    g = torch.from_numpy(rng.standard_normal((2, 16, 16, 3))
                         .astype(np.float32))
    for net in nets:
        (net(x, t) * g).sum().backward()
    # atol relative to the largest gradient element of the model: a conv
    # bias ahead of a GroupNorm of one channel per group has a true
    # gradient of zero (the norm removes any per-channel constant), so its
    # computed gradient is rounding noise on both sides.
    scale = max(float(p.grad.abs().max()) for p in nets[1].parameters()
                if p.grad is not None)
    for (name, p_k), p_p in zip(nets[0].named_parameters(),
                                nets[1].parameters()):
        if p_p.grad is None:      # dead weights: no gradient either way
            assert p_k.grad is None, name
            continue
        torch.testing.assert_close(p_k.grad, p_p.grad, rtol=1e-4,
                                   atol=1e-5 * scale, msg=name)
