"""The port's streaming attention (sdm_tpu_torch/kernels/streaming_attention)
against sdm_tpu's.

The plain stats and apply passes are held against the Pallas kernels of
sdm_tpu/kernels/streaming_attention.py::_forward run in interpret mode, and
the whole function against the XLA reference `_xla_attention`, on both
softmax axes in fp32 and bf16. The dispatchers (`attention`,
`fused_attention_block`) must send shapes beyond the whole-S kernel's shared
memory to the streaming kernel and all others to the whole-S kernel. The
CUDA kernels run only on a card (marker `cuda`).
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdm_tpu.kernels.attention import _xla_attention
from sdm_tpu.kernels.streaming_attention import _forward
from sdm_tpu_torch.kernels import attention as port_attention
from sdm_tpu_torch.kernels import attention_block as port_block
from sdm_tpu_torch.kernels import streaming_attention as port_streaming
from sdm_tpu_torch.kernels.streaming_attention import (
    streaming_apply, streaming_apply_reference, streaming_attention,
    streaming_attention_reference, streaming_dv, streaming_stats,
    streaming_stats_reference)

# fp32 plain version vs the JAX kernel and XLA: the same algorithm, another
# summation order (tests/test_kernels.py's streaming bound).
FP32 = dict(rtol=2e-4, atol=2e-5)
# q and k std: scores of std QK_STD**2 = 2.25 spread over several units, so
# the q- and k-axis softmaxes differ.
QK_STD = 1.5
BH, S, D = 2, 512, 128
AXES = {"q": 0, "k": 1}


def bf16_tol(ref):
    """bf16: the output's own rounding plus one-ulp flips of bf16 P
    entries: 1e-2 of the element plus 1e-2 of the largest output."""
    return dict(rtol=1e-2,
                atol=1e-2 * float(np.abs(np.asarray(ref, np.float32)).max()))


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


def _qkv(seed, shape=(BH, S, D)):
    rng = np.random.default_rng(seed)
    return [(std * rng.standard_normal(shape)).astype(np.float32)
            for std in (QK_STD, QK_STD, 1.0)]


def _both(arrays, dtype):
    """The same inputs as JAX arrays and torch tensors of one dtype."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(dtype) for a in arrays])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("axis", ["q", "k"])
def test_plain_passes_match_pallas_interpret(interpret, axis, dtype):
    """m, l and the output of the plain stats and apply passes against the
    TPU kernels' own (m, l, out) from `_forward`."""
    (jq, jk, jv), (q, k, v) = _both(_qkv(0), dtype)
    scale = D ** -0.5
    out_ref, m_ref, l_ref = _forward(jq, jk, jv, scale, AXES[axis])
    m, l = streaming_stats_reference(q, k, scale, axis)
    assert m.shape == l.shape == (BH, 1, S) and m.dtype == torch.float32
    np.testing.assert_allclose(_np(m), np.asarray(m_ref), **FP32)
    np.testing.assert_allclose(_np(l), np.asarray(l_ref), **FP32)
    out = streaming_apply_reference(q, k, v, m, l, scale, axis)
    assert out.dtype == dtype and out.shape == (BH, S, D)
    want = np.asarray(jnp.asarray(out_ref).astype(jq.dtype), np.float32)
    tol = FP32 if dtype == torch.float32 else bf16_tol(want)
    np.testing.assert_allclose(_np(out), want, **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("axis", ["q", "k"])
def test_plain_streaming_matches_xla(axis, dtype):
    """The whole plain function against the XLA reference, on a ragged S
    (not a multiple of the tile)."""
    (jq, jk, jv), (q, k, v) = _both(_qkv(1, (BH, 300, 64)), dtype)
    ref = _xla_attention(*(a[:, :, None] for a in (jq, jk, jv)), 64 ** -0.5,
                         axis)[:, :, 0]
    ours = streaming_attention_reference(q, k, v, 64 ** -0.5, axis)
    want = np.asarray(ref, np.float32)
    tol = FP32 if dtype == torch.float32 else bf16_tol(want)
    np.testing.assert_allclose(_np(ours), want, **tol)


def test_bf16_tolerance_rejects_wrong_axis():
    """Negative control: the bf16 bound sees the softmax axis. The plain
    streaming version with the other axis fails against XLA's q axis."""
    (jq, jk, jv), (q, k, v) = _both(_qkv(2), torch.bfloat16)
    ref = np.asarray(_xla_attention(*(a[:, :, None] for a in (jq, jk, jv)),
                                    D ** -0.5, "q")[:, :, 0], np.float32)
    wrong = streaming_attention_reference(q, k, v, D ** -0.5, "k")
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(_np(wrong), ref, **bf16_tol(ref))


def test_wrappers_take_plain_version_on_cpu():
    """On CPU tensors the wrappers run the plain passes and launch
    nothing; streaming_attention is the two in turn."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, (2, 70, 16)))
    before = (streaming_stats.launches, streaming_apply.launches,
              streaming_stats.mma_launches, streaming_apply.mma_launches,
              streaming_dv.mma_launches)
    m, l = streaming_stats(q, k, 0.25, "k")
    m_ref, l_ref = streaming_stats_reference(q, k, 0.25, "k")
    torch.testing.assert_close(m, m_ref, rtol=0, atol=0)
    torch.testing.assert_close(l, l_ref, rtol=0, atol=0)
    out = streaming_apply(q, k, v, m, l, 0.25, "k")
    torch.testing.assert_close(
        out, streaming_apply_reference(q, k, v, m, l, 0.25, "k"),
        rtol=0, atol=0)
    torch.testing.assert_close(streaming_attention(q, k, v, 0.25, "k"), out,
                               rtol=0, atol=0)
    streaming_dv(q, k, v, m, l, 0.25, "k")
    assert (streaming_stats.launches, streaming_apply.launches,
            streaming_stats.mma_launches, streaming_apply.mma_launches,
            streaming_dv.mma_launches) == before


def test_wrappers_refuse_other_devices():
    q, k, v = (torch.empty((2, 8, 4), device="meta") for _ in range(3))
    m = torch.empty((2, 1, 8), device="meta")
    with pytest.raises(ValueError, match="kernel runs on CUDA"):
        streaming_stats(q, k, 1.0)
    with pytest.raises(ValueError, match="kernel runs on CUDA"):
        streaming_apply(q, k, v, m, m, 1.0)


def test_whole_s_predicate_is_the_shared_memory_formula():
    """whole_s_ok mirrors csrc/attention.cu's sdm_attention_fits: the bf16
    tensor-core path takes S up to MAX_S_MMA = 3200 (where the former WMMA
    apply's P [32][S+8] block stopped fitting), the CUDA-core one while its
    [32][S+1] fp32 block fits, and the SR model's S = 4096 takes neither."""
    def t(s, d, dtype):
        return torch.zeros((1, s, 1, d), dtype=dtype)

    cases = {(1024, 512, torch.bfloat16): True,
             (1024, 1024, torch.bfloat16): True,
             (3200, 512, torch.bfloat16): True,
             (3264, 512, torch.bfloat16): False,
             (4096, 512, torch.bfloat16): False,
             (1024, 512, torch.float32): True,
             (1687, 64, torch.float32): True,
             (1688, 64, torch.float32): False,
             # bf16 off the tensor-core path keeps an fp32 block.
             (2048, 72, torch.bfloat16): False,
             (2048, 512, torch.bfloat16): True}
    for (s, d, dtype), fits in cases.items():
        x = t(s, d, dtype)
        assert port_attention.whole_s_ok(x, x, x) is fits, (s, d, dtype)


def _meta(shape, dtype=torch.bfloat16):
    """A tensor with a layout and no storage (the SR shape without 64 MB)."""
    return torch.empty(shape, dtype=dtype, device="meta")


# (S, D) of every attention block of the flagship 128x128 and the SR
# 256x256 U-Net (chip_smoke.py BLOCK_SHAPES and SR_BLOCK_SHAPES).
UNET_BLOCKS = [(1024, 512), (256, 512), (64, 1024), (256, 1024), (4096, 512),
               (1024, 1024)]


@pytest.mark.parametrize("shape", UNET_BLOCKS)
@pytest.mark.parametrize("views", [False, True])
def test_stats_mma_admits_the_unet_shapes(shape, views):
    """Every U-Net block's stats pass runs on the tensor cores in bf16, on
    stream_stats_wgmma: contiguous, and as the attention block passes
    them, strided q and k views of one (16, S, 3 * D) qkv buffer."""
    s, d = shape
    if views:
        q, k, _ = _meta((16, s, 3 * d)).split(d, dim=-1)
        assert q.stride() == (s * 3 * d, 3 * d, 1)
    else:
        q, k = _meta((16, s, d)), _meta((16, s, d))
    assert port_streaming.stats_takes_wgmma(q, k)


@pytest.mark.parametrize("case", ["fp32", "s300", "s96", "d72", "d1152",
                                  "d1280", "stride", "pointer"])
def test_stats_mma_refuses_other_shapes(case):
    """fp32, S % 64 != 0, D off the 64 grid or past 1024, a row stride that
    is not a multiple of 8 elements, and a pointer off 16 bytes all take
    the CUDA-core stats."""
    shape = {"s300": (2, 300, 512), "s96": (2, 96, 512), "d72": (2, 256, 72),
             "d1152": (2, 256, 1152), "d1280": (2, 256, 1280)}.get(
                 case, (2, 256, 512))
    dtype = torch.float32 if case == "fp32" else torch.bfloat16
    q, k = (torch.zeros(shape, dtype=dtype) for _ in range(2))
    if case == "stride":
        k = torch.zeros((2, 256, 516), dtype=dtype)[:, :, :512]
        assert k.stride(1) % 8 == 4
    if case == "pointer":
        q = torch.zeros(2 * 256 * 512 + 4, dtype=dtype)[4:].view(2, 256, 512)
        assert q.data_ptr() % 16 == 8
    assert not port_streaming.stats_takes_wgmma(q, k)
    aligned = torch.zeros((2, 256, 512), dtype=torch.bfloat16)
    assert port_streaming.stats_takes_wgmma(aligned, aligned)


def _record(monkeypatch, module, calls):
    monkeypatch.setattr(module, "fused_attention",
                        lambda q, k, v, *a: calls.append("whole")
                        or port_attention.attention_reference(
                            q, k, v, *a).contiguous())
    monkeypatch.setattr(module, "streaming_attention",
                        lambda q, k, v, *a: calls.append("streaming")
                        or streaming_attention_reference(q, k, v, *a))


@pytest.mark.parametrize("heads", [1, 2])
def test_attention_dispatcher_streams_long_grids(monkeypatch, heads):
    """S = 1760 (fp32) is past the whole-S block: streaming, with the same
    output as the plain version; S = 64 stays on the whole-S kernel."""
    calls = []
    _record(monkeypatch, port_attention, calls)
    for s, want in ((1760, "streaming"), (64, "whole")):
        q, k, v = (torch.from_numpy(a) for a in _qkv(4, (1, s, heads, 8)))
        out = port_attention.attention(q, k, v, 0.3, "q", use_kernels=True)
        assert calls[-1] == want
        assert out.shape == (1, s, heads, 8) and out.is_contiguous()
        ref = port_attention.attention_reference(q, k, v, 0.3, "q")
        np.testing.assert_allclose(_np(out), _np(ref), **FP32)
    port_attention.attention(q, k, v, 0.3, "q", use_kernels=False)
    assert calls == ["streaming", "whole"]


def test_block_dispatcher_streams_long_grids(monkeypatch):
    """The block on CUDA tensors: past the whole-S predicate, the composed
    path (linear, streaming on views of the qkv buffer, linear); at whole-S
    shapes one C call and nothing else."""
    calls = []
    monkeypatch.setattr(port_block, "streaming_attention",
                        lambda q, k, v, *a: calls.append("streaming")
                        or streaming_attention_reference(q, k, v, *a))

    class Lib:
        def sdm_attention_block_forward(self, *args):
            calls.append("whole")
            return 0
    monkeypatch.setattr(port_block._build, "library", lambda *a, **k: Lib())
    monkeypatch.setattr(port_block._build, "on_device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(port_block._build, "stream_handle", lambda d: 0)
    rng = np.random.default_rng(5)
    c = 8
    w_qkv = torch.from_numpy(rng.uniform(-0.3, 0.3, (3 * c, c))
                             .astype(np.float32))
    b_qkv, b_out = (torch.from_numpy(rng.uniform(-0.3, 0.3, n)
                                     .astype(np.float32)) for n in (3 * c, c))
    w_out = torch.from_numpy(rng.uniform(-0.3, 0.3, (c, c))
                             .astype(np.float32))
    # The block's CUDA branch on CPU tensors: the composed path's linear
    # steps then take their plain version.
    monkeypatch.setattr(port_block._build, "require_cuda",
                        lambda *a, **k: None)
    for s, want in ((1760, "streaming"), (64, "whole")):
        tok = torch.from_numpy(
            (2.6 * rng.standard_normal((1, s, c))).astype(np.float32))
        args = (tok, w_qkv, b_qkv, w_out, b_out, c ** -0.5, "k")
        out = port_block._launch_block(*args)
        assert calls[-1] == want
        if want == "streaming":
            np.testing.assert_allclose(
                _np(out),
                _np(port_block.attention_block_reference(*args)), **FP32)
    assert calls == ["streaming", "whole"]


# ------------------------------------------------------------- on the card

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("axis", ["q", "k"])
def test_cuda_streaming_matches_plain(cuda, dtype, axis):
    """Both kernels launch and agree with their plain versions, on a
    tensor-core shape and a ragged one; the bf16 tensor-core shape's stats
    and apply each count as a tensor-core (wgmma) launch."""
    for shape in ((2, 256, 128), (2, 100, 72)):
        q, k, v = (torch.from_numpy(a).to(cuda, dtype)
                   for a in _qkv(6, shape))
        before = (streaming_stats.launches, streaming_apply.launches,
                  streaming_stats.mma_launches, streaming_apply.mma_launches)
        m, l = streaming_stats(q, k, 0.1, axis)
        out = streaming_apply(q, k, v, m, l, 0.1, axis)
        torch.cuda.synchronize()
        mma = port_streaming.apply_takes_wgmma(q, k, v, out)
        assert mma == port_streaming.stats_takes_wgmma(q, k) == (
            dtype == torch.bfloat16 and shape[1] == 256)
        assert (streaming_stats.launches, streaming_apply.launches,
                streaming_stats.mma_launches,
                streaming_apply.mma_launches) == (
                    before[0] + 1, before[1] + 1, before[2] + mma,
                    before[3] + mma)
        m_ref, l_ref = streaming_stats_reference(q, k, 0.1, axis)
        torch.testing.assert_close(m, m_ref, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(l, l_ref, rtol=1e-4, atol=1e-5)
        want = streaming_apply_reference(q, k, v, m, l, 0.1, axis).float()
        tol = (FP32 if dtype == torch.float32
               else bf16_tol(_np(want)))
        torch.testing.assert_close(out.float(), want, **tol)
