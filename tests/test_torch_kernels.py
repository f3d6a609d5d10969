"""The port's kernel modules (sdm_tpu_torch/kernels) against sdm_tpu's.

Each plain PyTorch version is held against the JAX XLA reference
(`_xla_adagn`, `_xla_attention`, `_xla_block`) and against the Pallas kernel
run in interpret mode, as tests/test_kernels.py runs it on the CPU. The
CUDA kernels themselves run only on a card (marker `cuda`); here the
wrappers must take the plain version for CPU tensors and refuse any other
non-CUDA device.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdm_tpu.kernels.adagn import _fused_adagn_impl, _xla_adagn
from sdm_tpu.kernels.attention import _fused_attention_fwd_impl, _xla_attention
from sdm_tpu.kernels.attention_block import _xla_block
from sdm_tpu.kernels.attention_block import \
    fused_attention_block as jax_fused_attention_block
from sdm_tpu_torch.kernels import _build
from sdm_tpu_torch.kernels import attention as port_attention
from sdm_tpu_torch.kernels.adagn import adagn_reference, fused_adagn
from sdm_tpu_torch.kernels.attention import (attention_reference,
                                             fused_attention)
from sdm_tpu_torch.kernels.attention_block import (
    attention_block_reference, fused_attention_block, linear,
    linear_reference)

# fp32 plain version vs XLA on the CPU: same algorithm, other summation
# order.
FP32 = dict(atol=2e-5, rtol=2e-4)
# bf16: both sides round at the same places, but an fp32 intermediate that
# differs in its last bit can flip one bf16 rounding (2^-8 relative).
BF16 = dict(atol=2e-2, rtol=2e-2)
# q and k std: the scores' std is QK_STD**2 = 2.25, so the softmax is far
# from uniform and the q and k axes give different outputs.
QK_STD = 1.5


def attn_bf16_tol(ref):
    """bf16 attention: the output's own rounding (at most 2^-7 of the
    element) plus one-ulp flips of bf16 P entries, which move an output by
    an amount set by the output's scale: 1e-2 of the element plus 1e-2 of
    the largest output."""
    return dict(atol=1e-2 * float(np.abs(np.asarray(ref, np.float32)).max()),
                rtol=1e-2)


@pytest.fixture
def interpret(monkeypatch):
    from jax.experimental.pallas import tpu as pltpu
    monkeypatch.setenv("SDM_TPU_PALLAS_INTERPRET", "1")
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _np(t):
    return t.detach().to(torch.float32).cpu().numpy()


def _adagn_inputs(rng, n, h, w, c, film_rows):
    x = (rng.standard_normal((n, h, w, c)) * 2.0 + 0.5).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    s = (1.0 + 0.5 * rng.standard_normal((film_rows, c))).astype(np.float32)
    t = (0.5 * rng.standard_normal((film_rows, c))).astype(np.float32)
    return x, gamma, beta, s, t


# ------------------------------------------------------------------ AdaGN

@pytest.mark.parametrize("film_rows", [2, 1])
def test_adagn_plain_matches_xla(film_rows):
    """(N, C) FiLM tables and the (1, C) ones a one-step t gives."""
    args = _adagn_inputs(np.random.default_rng(0), 2, 8, 8, 64, film_rows)
    ref = _xla_adagn(*map(jnp.asarray, args), 32, 1e-5)
    ours = adagn_reference(*map(torch.from_numpy, args), 32)
    np.testing.assert_allclose(_np(ours), np.asarray(ref), **FP32)


def test_adagn_plain_matches_pallas_interpret(interpret):
    args = _adagn_inputs(np.random.default_rng(1), 2, 16, 16, 128, 2)
    ref = _fused_adagn_impl(*map(jnp.asarray, args), 32, 1e-5)
    ours = adagn_reference(*map(torch.from_numpy, args), 32)
    np.testing.assert_allclose(_np(ours), np.asarray(ref), **FP32)


def test_adagn_dtype_promotion_matches_xla():
    """bf16 x with fp32 FiLM tables promotes to fp32 on both sides."""
    x, gamma, beta, s, t = _adagn_inputs(np.random.default_rng(2), 2, 4, 4,
                                         32, 2)
    ref = _xla_adagn(jnp.asarray(x, jnp.bfloat16), jnp.asarray(gamma),
                     jnp.asarray(beta), jnp.asarray(s), jnp.asarray(t), 32,
                     1e-5)
    ours = adagn_reference(torch.from_numpy(x).to(torch.bfloat16),
                           *map(torch.from_numpy, (gamma, beta, s, t)), 32)
    assert ref.dtype == jnp.float32 and ours.dtype == torch.float32
    np.testing.assert_allclose(_np(ours), np.asarray(ref), **BF16)


# -------------------------------------------------------------- attention

def _qkv(rng, shape):
    return [(std * rng.standard_normal(shape)).astype(np.float32)
            for std in (QK_STD, QK_STD, 1.0)]


@pytest.mark.parametrize("axis", ["q", "k"])
def test_attention_plain_matches_xla(axis):
    q, k, v = _qkv(np.random.default_rng(3), (2, 64, 2, 32))
    ref = _xla_attention(*map(jnp.asarray, (q, k, v)), 32 ** -0.5, axis)
    ours = attention_reference(*map(torch.from_numpy, (q, k, v)),
                               32 ** -0.5, axis)
    np.testing.assert_allclose(_np(ours), np.asarray(ref), **FP32)


@pytest.mark.parametrize("shape", [(2, 256, 1, 128), (1, 128, 2, 128)])
@pytest.mark.parametrize("axis", ["q", "k"])
def test_attention_plain_matches_pallas_interpret(interpret, axis, shape):
    q, k, v = _qkv(np.random.default_rng(4), shape)
    d = shape[-1]
    ref = _fused_attention_fwd_impl(*map(jnp.asarray, (q, k, v)), d ** -0.5,
                                    axis)
    ours = attention_reference(*map(torch.from_numpy, (q, k, v)),
                               d ** -0.5, axis)
    np.testing.assert_allclose(_np(ours), np.asarray(ref), **FP32)


def test_attention_plain_matches_xla_bf16():
    """P is cast to v's dtype before P V on both sides."""
    q, k, v = _qkv(np.random.default_rng(5), (2, 64, 1, 64))
    ref = _xla_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                         64 ** -0.5, "q")
    ours = attention_reference(*(torch.from_numpy(a).to(torch.bfloat16)
                                 for a in (q, k, v)), 64 ** -0.5, "q")
    assert ours.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(ours), np.asarray(ref, np.float32),
                               **attn_bf16_tol(ref))


# ---------------------------------------------------------------- block

# Token std: q = tok W_q with W uniform in +-1/sqrt(c) has std TOK_STD/sqrt(3),
# so the scores' std is TOK_STD**2 / 3, about 2.25 as in the attention tests.
TOK_STD = 2.6


def _block_inputs(rng, n, s, c):
    bound = 1.0 / np.sqrt(c)
    tok = (TOK_STD * rng.standard_normal((n, s, c))).astype(np.float32)
    w_qkv = rng.uniform(-bound, bound, (c, 3 * c)).astype(np.float32)
    b_qkv = rng.uniform(-bound, bound, 3 * c).astype(np.float32)
    w_out = rng.uniform(-bound, bound, (c, c)).astype(np.float32)
    b_out = rng.uniform(-bound, bound, c).astype(np.float32)
    return tok, w_qkv, b_qkv, w_out, b_out


def _port_block_args(tok, w_qkv, b_qkv, w_out, b_out, dtype=torch.float32):
    """flax (in, out) kernels -> nn.Linear (out, in) weights."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    return (t(tok), t(w_qkv.T), torch.from_numpy(b_qkv), t(w_out.T),
            torch.from_numpy(b_out))


@pytest.mark.parametrize("axis", ["q", "k"])
def test_block_plain_matches_xla(axis):
    args = _block_inputs(np.random.default_rng(6), 2, 64, 32)
    ref = _xla_block(*map(jnp.asarray, args), 32 ** -0.5, axis)
    ours = attention_block_reference(*_port_block_args(*args), 32 ** -0.5,
                                     axis)
    np.testing.assert_allclose(_np(ours), np.asarray(ref), **FP32)


@pytest.mark.parametrize("axis", ["q", "k"])
def test_block_plain_matches_pallas_interpret(interpret, axis):
    args = _block_inputs(np.random.default_rng(7), 2, 256, 128)
    ref = jax_fused_attention_block(*map(jnp.asarray, args), 128 ** -0.5,
                                    axis)
    ours = attention_block_reference(*_port_block_args(*args), 128 ** -0.5,
                                     axis)
    np.testing.assert_allclose(_np(ours), np.asarray(ref), **FP32)


def test_block_plain_matches_xla_bf16():
    """qkv cast after the bias, r cast before the output projection, the
    tokens added in bf16: the rounding points of _xla_block."""
    args = _block_inputs(np.random.default_rng(8), 2, 64, 32)
    ref = _xla_block(jnp.asarray(args[0], jnp.bfloat16),
                     *map(jnp.asarray, args[1:]), 32 ** -0.5, "q")
    ours = attention_block_reference(
        *_port_block_args(*args, dtype=torch.bfloat16), 32 ** -0.5, "q")
    assert ours.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(ours), np.asarray(ref, np.float32), **BF16)


@pytest.mark.parametrize("kernel", ["attention", "block"])
def test_bf16_tolerance_rejects_wrong_axis(kernel):
    """Negative control: the bf16 tolerances above see the softmax axis. The
    plain version with the other axis fails against the XLA reference."""
    rng = np.random.default_rng(12)
    if kernel == "attention":
        args = _qkv(rng, (2, 256, 1, 64))
        ref = _xla_attention(*(jnp.asarray(a, jnp.bfloat16) for a in args),
                             64 ** -0.5, "q")
        wrong = attention_reference(*(torch.from_numpy(a).to(torch.bfloat16)
                                      for a in args), 64 ** -0.5, "k")
        tol = attn_bf16_tol(ref)
    else:
        args = _block_inputs(rng, 2, 64, 32)
        ref = _xla_block(jnp.asarray(args[0], jnp.bfloat16),
                         *map(jnp.asarray, args[1:]), 32 ** -0.5, "q")
        wrong = attention_block_reference(
            *_port_block_args(*args, dtype=torch.bfloat16), 32 ** -0.5, "k")
        tol = BF16
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(_np(wrong), np.asarray(ref, np.float32),
                                   **tol)


def test_linear_plain_matches_numpy():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((6, 5)).astype(np.float32)
    w = rng.standard_normal((4, 5)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    res = rng.standard_normal((6, 4)).astype(np.float32)
    ours = linear_reference(*map(torch.from_numpy, (x, w, b, res)))
    np.testing.assert_allclose(_np(ours), x @ w.T + b + res, **FP32)


# --------------------------------------------------------------- wrappers

def _small_cases():
    rng = np.random.default_rng(10)
    adagn = tuple(map(torch.from_numpy,
                      _adagn_inputs(rng, 2, 4, 4, 32, 1))) + (32,)
    attn = tuple(map(torch.from_numpy, _qkv(rng, (2, 16, 1, 8)))) \
        + (8 ** -0.5, "q")
    block = _port_block_args(*_block_inputs(rng, 2, 16, 8)) \
        + (8 ** -0.5, "k")
    return [(fused_adagn, adagn_reference, adagn),
            (fused_attention, attention_reference, attn),
            (fused_attention_block, attention_block_reference, block)]


def test_wrappers_take_plain_version_on_cpu():
    """CPU tensors run the plain version and launch nothing."""
    for wrapper, plain, args in _small_cases():
        before = wrapper.launches
        torch.testing.assert_close(wrapper(*args), plain(*args), rtol=0,
                                   atol=0)
        assert wrapper.launches == before


def test_wrappers_refuse_other_devices():
    """A tensor neither on the CPU nor on CUDA is refused, never run."""
    for wrapper, _, args in _small_cases():
        meta = tuple(a.to("meta") if isinstance(a, torch.Tensor) else a
                     for a in args)
        with pytest.raises(ValueError, match="kernel runs on CUDA"):
            wrapper(*meta)
    x, w, b = (torch.empty(s, device="meta") for s in ((4, 3), (2, 3), (2,)))
    with pytest.raises(ValueError, match="kernel runs on CUDA"):
        linear(x, w, b)


def test_attention_dispatcher(monkeypatch):
    calls = []
    monkeypatch.setattr(port_attention, "fused_attention",
                        lambda *a: calls.append("kernel")
                        or attention_reference(*a))
    q, k, v = (torch.from_numpy(a) for a in _qkv(np.random.default_rng(11),
                                                  (1, 32, 2, 8)))
    port_attention.attention(q, k, v, 0.3, "q", use_kernels=False)
    assert calls == []
    # Every shape goes to the kernel, the TPU's small-grid XLA rule aside.
    port_attention.attention(q, k, v, 0.3, "q", use_kernels=True)
    assert calls == ["kernel"]


def test_kernel_sources_export_the_wrapped_symbols():
    """Each library's C entry point exists in its source with the argument
    count the ctypes wrapper declares, and the build targets sm_90a."""
    from sdm_tpu_torch.kernels import (adagn, attention_block,
                                       streaming_attention)
    for name, sigs in (("adagn", adagn._SIGNATURES),
                       ("attention", port_attention._SIGNATURES),
                       ("linear", attention_block._SIGNATURES),
                       ("streaming_attention",
                        streaming_attention._SIGNATURES)):
        with open(os.path.join(_build.CSRC, f"{name}.cu")) as f:
            src = f.read()
        for symbol, (_, argtypes) in sigs.items():
            m = re.search(r"SDM_EXPORT int " + symbol + r"\(([^)]*)\)", src)
            assert m, symbol
            assert len(m.group(1).split(",")) == len(argtypes), symbol
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert set(_build.SOURCES) == {"adagn", "attention", "linear",
                                   "streaming_attention"}


# ------------------------------------------------------------- on the card

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain(cuda, dtype):
    """Each kernel launches and agrees with its plain version on the card."""
    for wrapper, plain, args in _small_cases():
        args = tuple(a.to(cuda, dtype) if isinstance(a, torch.Tensor)
                     and a.ndim > 1 else
                     a.to(cuda) if isinstance(a, torch.Tensor) else a
                     for a in args)
        before = wrapper.launches
        got = wrapper(*args)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        want = plain(*args).float()
        tol = (dict(atol=1e-4, rtol=1e-3) if dtype == torch.float32
               else attn_bf16_tol(_np(want)) if wrapper is fused_attention
               else BF16)
        torch.testing.assert_close(got.float(), want, **tol)
