"""The port's streaming attention backward (dV, dK, dQ and the autograd
Function of sdm_tpu_torch/kernels/streaming_attention.py) against sdm_tpu's.

The plain dV, dK and dQ passes are held against the Pallas kernels of
sdm_tpu/kernels/streaming_attention.py (`_dv`, `_backward`) run in interpret
mode on the same m, l and corr, and the Function's gradients against
`jax.vjp` of sdm_tpu's `streaming_attention`, on both softmax axes. bf16 on
the query axis is cancellation-dominated (BASELINE.md "On-TPU kernel
numerics"), so there both packages are also held to a float64 truth. The
Python mirrors of the TMA + wgmma dK/dQ kernel's admission
(`da_takes_wgmma`) and its emulation are in tests/test_torch_da_wgmma.py;
`chip_smoke.py` holds the mirrors to the C functions. The CUDA kernels run
only on a card (marker `cuda`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdm_tpu.kernels.streaming_attention import (_backward, _dv, _forward,
                                                 streaming_attention
                                                 as jax_streaming)
from sdm_tpu_torch.kernels import streaming_attention as sa

# fp32 plain version vs the Pallas kernel: the same tile algorithm, another
# summation order.
FP32 = dict(rtol=2e-4, atol=2e-5)
QK_STD = 1.5
BH, S, D = 2, 512, 128
AXES = {"q": 0, "k": 1}
SCALE = D ** -0.5
# bf16 plain passes vs the Pallas kernels: both round P (or dA) to bf16
# after an fp32 sum in another order, so a one-ulp flip of a rounded entry
# moves an output element by a share of the output's scale.
BF16_OF_MAX = 2e-2
# Float64-truth bound for bf16 on the query axis: the port's error (max
# |x - truth| / max|truth|) at most TRUTH_MULT times sdm_tpu's plus
# TRUTH_ADD.
TRUTH_MULT, TRUTH_ADD = 2.0, 1e-3


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
    return np.asarray(t.detach().to(torch.float32).cpu().numpy()
                      if isinstance(t, torch.Tensor) else t, np.float32)


def _inputs(seed, shape=(BH, S, D)):
    """q, k (std QK_STD), v, g (std 1) as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    return [(std * rng.standard_normal(shape)).astype(np.float32)
            for std in (QK_STD, QK_STD, 1.0, 1.0)]


def _both(arrays, dtype):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(dtype) for a in arrays])


def _close(got, want, dtype):
    want = np.asarray(want, np.float32)
    if dtype == torch.float32:
        np.testing.assert_allclose(_np(got), want, **FP32)
    else:
        np.testing.assert_allclose(
            _np(got), want, rtol=BF16_OF_MAX,
            atol=BF16_OF_MAX * float(np.abs(want).max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("axis", ["q", "k"])
def test_plain_backward_passes_match_pallas_interpret(interpret, axis, dtype):
    """dV against `_dv`, then dK and dQ against `_backward`, each side fed
    the same m, l (from `_forward`) and the same corr (from JAX's dV, or
    from the fp32 forward output on the key axis)."""
    (jq, jk, jv, jg), (q, k, v, g) = _both(_inputs(0), dtype)
    ax = AXES[axis]
    out32, m_j, l_j = _forward(jq, jk, jv, SCALE, ax)
    dv_j = _dv(jq, jk, jg, m_j, l_j, SCALE, ax)
    m, l = (torch.from_numpy(np.asarray(a)) for a in (m_j, l_j))
    dv = sa.streaming_dv_reference(q, k, g, m, l, SCALE, axis)
    assert dv.dtype == torch.float32 and dv.shape == (BH, S, D)
    _close(dv, dv_j, dtype)

    if axis == "q":
        corr_j = jnp.sum(dv_j * jv.astype(jnp.float32), axis=-1)[:, None, :]
    else:
        corr_j = jnp.sum(jg.astype(jnp.float32) * out32, axis=-1)[:, None, :]
    dq_j, dk_j = _backward(jq, jk, jv, m_j, l_j, corr_j, jg, SCALE, ax)
    corr = torch.from_numpy(np.asarray(corr_j))
    dk = sa.streaming_dk_reference(q, k, v, g, m, l, corr, SCALE, axis)
    dq = sa.streaming_dq_reference(q, k, v, g, m, l, corr, SCALE, axis)
    _close(dk, dk_j, dtype)
    _close(dq, dq_j, dtype)
    # The port's own correction term equals the one the JAX VJP builds.
    out32_t = torch.from_numpy(np.asarray(out32))
    np.testing.assert_allclose(
        _np(sa.streaming_correction(g, v, out32_t, dv, axis)),
        np.asarray(corr_j), rtol=1e-4,
        atol=1e-4 * float(np.abs(np.asarray(corr_j)).max()))


def _jax_grads(jq, jk, jv, jg, axis, scale=SCALE):
    _, vjp = jax.vjp(lambda a, b, c: jax_streaming(a, b, c, scale, axis),
                     jq, jk, jv)
    return [np.asarray(x, np.float32) for x in vjp(jg)]


def _port_grads(q, k, v, g, axis, scale=SCALE):
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = sa.streaming_attention(*leaves, scale, axis)
    assert out.dtype == q.dtype
    out.backward(g)
    return [t.grad for t in leaves]


@pytest.mark.parametrize("axis", ["q", "k"])
def test_function_grads_match_jax_vjp(interpret, axis):
    """fp32: the Function's dq, dk, dv against jax.vjp of sdm_tpu's custom
    VJP, on a ragged S for the port (the plain passes mask nothing; the tile
    loop just ends short) and on the TPU tile for JAX."""
    (jq, jk, jv, jg), (q, k, v, g) = _both(_inputs(1), torch.float32)
    for got, want in zip(_port_grads(q, k, v, g, axis),
                         _jax_grads(jq, jk, jv, jg, axis)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), want, **FP32)


def _truth(arrays, axis, scale=SCALE):
    """float64 dq, dk, dv of softmax(q k^T scale, axis) v against g."""
    q, k, v, g = (torch.from_numpy(np.asarray(a, np.float64))
                  .requires_grad_() for a in arrays)
    p = torch.softmax(q @ k.transpose(-1, -2) * scale,
                      dim=-2 if axis == "q" else -1)
    return [x.numpy() for x in torch.autograd.grad(p @ v, (q, k, v),
                                                   g.detach())]


def _err(x, truth):
    return float(np.abs(np.asarray(x, np.float64) - truth).max()
                 / np.abs(truth).max())


def test_bf16_query_axis_against_float64_truth(interpret):
    """bf16, q axis: on the same bf16-rounded inputs, each of the port's
    gradients is within TRUTH_MULT x sdm_tpu's error against a float64
    truth (+ TRUTH_ADD)."""
    (jq, jk, jv, jg), (q, k, v, g) = _both(_inputs(2), torch.bfloat16)
    rounded = [_np(t) for t in (q, k, v, g)]
    truth = _truth(rounded, "q")
    ours = _port_grads(q, k, v, g, "q")
    theirs = _jax_grads(jq, jk, jv, jg, "q")
    for name, o, t, tr in zip("qkv", ours, theirs, truth):
        e_port, e_jax = _err(_np(o), tr), _err(t, tr)
        assert e_port <= TRUTH_MULT * e_jax + TRUTH_ADD, (name, e_port,
                                                          e_jax)


def test_grad_bound_rejects_wrong_axis(interpret):
    """Negative control: the query-axis gradients fail the fp32 bound
    against sdm_tpu's key-axis gradients."""
    (jq, jk, jv, jg), (q, k, v, g) = _both(_inputs(3), torch.float32)
    ours = _port_grads(q, k, v, g, "q")
    wrong = _jax_grads(jq, jk, jv, jg, "k")
    for got, want in zip(ours, wrong):
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(_np(got), want, **FP32)


def test_function_on_ragged_s_matches_dense_autograd():
    """S = 300 (not a multiple of the tile), float64 inputs: the Function's
    gradients equal dense autograd of the same function to fp32 accuracy,
    both axes (the plain passes compute in fp32)."""
    arrays = _inputs(4, (2, 300, 16))
    q, k, v, g = (torch.from_numpy(a).double() for a in arrays)
    for axis in ("q", "k"):
        ours = _port_grads(q, k, v, g, axis, scale=0.25)
        for got, want in zip(ours, _truth(arrays, axis, scale=0.25)):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                       atol=1e-5)


def test_wrappers_take_plain_version_on_cpu_and_refuse_others():
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(5, (2, 70, 16)))
    m, l = sa.streaming_stats_reference(q, k, 0.25, "k")
    corr = torch.zeros_like(m)
    before = (sa.streaming_dv.launches, sa.streaming_dk.launches,
              sa.streaming_dq.launches)
    torch.testing.assert_close(
        sa.streaming_dv(q, k, g, m, l, 0.25, "k"),
        sa.streaming_dv_reference(q, k, g, m, l, 0.25, "k"), rtol=0, atol=0)
    torch.testing.assert_close(
        sa.streaming_dk(q, k, v, g, m, l, corr, 0.25, "k"),
        sa.streaming_dk_reference(q, k, v, g, m, l, corr, 0.25, "k"),
        rtol=0, atol=0)
    torch.testing.assert_close(
        sa.streaming_dq(q, k, v, g, m, l, corr, 0.25, "k"),
        sa.streaming_dq_reference(q, k, v, g, m, l, corr, 0.25, "k"),
        rtol=0, atol=0)
    assert (sa.streaming_dv.launches, sa.streaming_dk.launches,
            sa.streaming_dq.launches) == before
    meta = [torch.empty((2, 8, 4), device="meta") for _ in range(4)]
    mm = torch.empty((2, 1, 8), device="meta")
    with pytest.raises(ValueError, match="kernel runs on CUDA"):
        sa.streaming_dv(meta[0], meta[1], meta[3], mm, mm, 1.0)
    with pytest.raises(ValueError, match="kernel runs on CUDA"):
        sa.streaming_dk(*meta, mm, mm, mm, 1.0)
    with pytest.raises(ValueError, match="kernel runs on CUDA"):
        sa.streaming_dq(*meta, mm, mm, mm, 1.0)


def test_cpu_calls_leave_every_counter_still():
    """A forward and backward of the Function on CPU tensors runs the plain
    passes alone: no launch count and no tensor-core count moves, dK's and
    dQ's included."""
    fns = (sa.streaming_stats, sa.streaming_apply, sa.streaming_dv,
           sa.streaming_dk, sa.streaming_dq)
    before = [(fn.launches, fn.mma_launches) for fn in fns]
    q, k, v, g = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in _inputs(8, (2, 64, 128)))
    for axis in ("q", "k"):
        grads = _port_grads(q, k, v, g, axis)
        assert all(t.shape == (2, 64, 128) for t in grads)
    assert [(fn.launches, fn.mma_launches) for fn in fns] == before


def test_no_grad_forward_skips_the_function(monkeypatch):
    """Without a gradient the forward is the two passes alone (serving's
    path); with one it is the Function."""
    calls = []
    real = sa.StreamingAttention.apply
    monkeypatch.setattr(sa.StreamingAttention, "apply",
                        lambda *a: calls.append(1) or real(*a))
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(6, (1, 64, 8)))
    with torch.no_grad():
        sa.streaming_attention(q, k, v, 0.3, "q")
    assert calls == []
    sa.streaming_attention(q.requires_grad_(), k, v, 0.3, "q")
    assert calls == [1]


# ------------------------------------------------------------- on the card

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("axis", ["q", "k"])
def test_cuda_backward_kernels_match_plain(cuda, dtype, axis):
    """dV, dK and dQ launch and agree with their plain versions, on a
    tensor-core shape and a ragged one."""
    for shape in ((2, 256, 128), (2, 100, 72)):
        q, k, v, g = (torch.from_numpy(a).to(cuda, dtype)
                      for a in _inputs(7, shape))
        m, l = sa.streaming_stats(q, k, 0.1, axis)
        out32 = sa.streaming_apply(q, k, v, m, l, 0.1, axis,
                                   out_dtype=torch.float32)
        before = (sa.streaming_dv.launches, sa.streaming_dk.launches,
                  sa.streaming_dq.launches)
        wgmma_before = (sa.streaming_dk.wgmma_launches,
                        sa.streaming_dq.wgmma_launches)
        dv = sa.streaming_dv(q, k, g, m, l, 0.1, axis)
        corr = sa.streaming_correction(g, v, out32, dv, axis)
        dk = sa.streaming_dk(q, k, v, g, m, l, corr, 0.1, axis)
        dq = sa.streaming_dq(q, k, v, g, m, l, corr, 0.1, axis)
        torch.cuda.synchronize()
        assert (sa.streaming_dv.launches, sa.streaming_dk.launches,
                sa.streaming_dq.launches) == tuple(b + 1 for b in before)
        wgmma = int(sa.da_takes_wgmma(q, k, v, g, dk))
        assert (sa.streaming_dk.wgmma_launches,
                sa.streaming_dq.wgmma_launches) == tuple(
                    b + wgmma for b in wgmma_before)
        for got, want in (
                (dv, sa.streaming_dv_reference(q, k, g, m, l, 0.1, axis)),
                (dk, sa.streaming_dk_reference(q, k, v, g, m, l, corr, 0.1,
                                               axis)),
                (dq, sa.streaming_dq_reference(q, k, v, g, m, l, corr, 0.1,
                                               axis))):
            _close(got, _np(want), dtype)
