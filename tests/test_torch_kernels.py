"""The port's kernel modules (sdm_tpu_torch/kernels) against sdm_tpu's.

Each plain PyTorch version is held against the JAX XLA reference
(`_xla_adagn`, `_xla_attention`, `_xla_block`) and against the Pallas kernel
run in interpret mode, as tests/test_kernels.py runs it on the CPU. The
CUDA kernels themselves run only on a card (marker `cuda`); here the
wrappers must take the plain version for CPU tensors and refuse any other
non-CUDA device.
"""

import math
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
from sdm_tpu_torch.kernels import adagn as port_adagn
from sdm_tpu_torch.kernels import attention as port_attention
from sdm_tpu_torch.kernels import attention_block as port_block
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


def _bf16_ulp(a):
    """One bf16 ulp at each element of a (2^-7 of its binade, 8 bits of
    mantissa); at 0 the smallest normal's."""
    a = np.maximum(np.abs(np.asarray(a, np.float32)), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("bias_dtype", ["float32", "bfloat16"])
def test_linear_plain_matches_xla_rounding_bf16(bias_dtype):
    """bf16 with the residual: fp32 products and bias, one rounding to bf16,
    then the residual added and rounded again, the order of _xla_block
    (attention_block.py:121-131). Every element within one bf16 ulp of the
    JAX value: an fp32 sum in another order can flip the first rounding,
    and that flip carries through the second (one ulp of the larger of the
    rounded product and the output)."""
    rng = np.random.default_rng(13)
    m, n, k = 96, 80, 160
    x, res = (rng.standard_normal(sh).astype(np.float32) * 1.5
              for sh in ((m, k), (m, n)))
    w = (rng.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    jbf = jnp.bfloat16
    xj, wj, rj = (jnp.asarray(a, jbf) for a in (x, w, res))
    bj = jnp.asarray(b, jnp.dtype(bias_dtype))
    yj = (jnp.dot(xj, wj.T, preferred_element_type=jnp.float32)
          + bj.astype(jnp.float32)).astype(jbf)
    outj = yj + rj
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    bt = torch.from_numpy(b).to(getattr(torch, bias_dtype))
    y = linear_reference(tb(x), tb(w), bt)
    out = linear_reference(tb(x), tb(w), bt, residual=tb(res))
    assert y.dtype == out.dtype == torch.bfloat16
    y_ref = np.asarray(yj, np.float32)
    out_ref = np.asarray(outj, np.float32)
    assert (np.abs(_np(y) - y_ref) <= _bf16_ulp(y_ref)).all()
    ulp = _bf16_ulp(np.maximum(np.abs(y_ref), np.abs(out_ref)))
    assert (np.abs(_np(out) - out_ref) <= ulp).all()


@pytest.mark.parametrize("n,hw,groups,want", [
    (16, 128 * 128, 32, 17), (16, 8 * 8, 32, 17), (1, 256 * 256, 32, 128),
    (1, 8 * 8, 32, 64), (2, 3, 32, 3), (16, 64, 4096, 1), (16, 64, 8192, 1),
    (264, 16, 32, 1), (1000, 16, 32, 1)])
def test_adagn_chunk_plan(n, hw, groups, want):
    """adagn_chunks: about two statistics blocks per SM over (chunks, N), no
    chunk without a row, and at most MAX_PARTIALS partials a sample, so the
    apply's staged partials fit in 48 KB."""
    chunks = port_adagn.adagn_chunks(n, hw, groups)
    assert chunks == want
    assert 1 <= chunks <= hw
    assert chunks == 1 or chunks * groups <= port_adagn.MAX_PARTIALS
    assert chunks * groups * 8 <= 49152 or chunks == 1
    if chunks < min(hw, port_adagn.MAX_PARTIALS // groups):
        assert n * chunks >= port_adagn.WAVES * port_adagn.SMS


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
    mma_before = fused_attention.mma_launches
    linear_before = (linear.launches, linear.mma_launches)
    for wrapper, plain, args in _small_cases():
        before = wrapper.launches
        torch.testing.assert_close(wrapper(*args), plain(*args), rtol=0,
                                   atol=0)
        assert wrapper.launches == before
    assert fused_attention.mma_launches == mma_before
    assert (linear.launches, linear.mma_launches) == linear_before


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


# The whole-S attention blocks of the flagship 128x128 and the SR 256x256
# U-Net at batch 16, and D = 768, with csrc/attention.cu's wgmma_plan for
# each: (split, columns per split). Whole 64-column chunks, at most 512
# columns a block, the split of least cost over waves of one block an SM
# on 132 SMs (each split recomputes Q K^T).
WHOLE_S_PLANS = {(1024, 512): (1, 512), (256, 512): (2, 256),
                 (64, 1024): (8, 128), (256, 1024): (2, 512),
                 (1024, 1024): (2, 512), (1024, 768): (2, 384)}


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("shape", sorted(WHOLE_S_PLANS))
@pytest.mark.parametrize("views", [False, True])
def test_whole_s_mma_admits_the_unet_shapes(shape, views):
    """Every whole-S U-Net block runs on the TMA + wgmma path in bf16:
    contiguous, and as the attention block passes them, q, k, v as strided
    views of one (16, S, 1, 3 * D) qkv buffer."""
    s, d = shape
    if views:
        q, k, v = _meta((16, s, 1, 3 * d)).split(d, dim=-1)
    else:
        q, k, v = (_meta((16, s, 1, d)) for _ in range(3))
    assert port_attention.takes_wgmma(q, k, v)
    assert port_attention.whole_s_ok(q, k, v)


@pytest.mark.parametrize("shape", sorted(WHOLE_S_PLANS))
def test_whole_s_mma_plan(shape):
    """The split the C code chooses for attn_apply_wgmma: whole chunks, at
    least two splits past D = 512, each warpgroup's accumulator at most 256
    columns (half a split)."""
    s, d = shape
    split, per = port_attention.wgmma_plan(16, s, d)
    assert (split, per) == WHOLE_S_PLANS[shape]
    assert per % 64 == 0 and per <= port_attention.WGMMA_COLS
    assert (split - 1) * per < d <= split * per
    assert (split > 1) >= (d > 512)


@pytest.mark.parametrize("case", ["fp32", "s100", "d72", "d576", "d1152",
                                  "stride", "pointer", "heads"])
def test_whole_s_mma_refuses_other_shapes(case):
    """fp32, S % 64 != 0, D off the 64 grid or past 1024, a row stride or
    a head stride that is not a multiple of 8 elements, and a pointer off
    16 bytes all take the CUDA-core kernels; D = 576, off the former
    mma.sync path's 128 grid, is on the 64 grid of the wgmma one."""
    shape = {"s100": (2, 100, 1, 512), "d72": (2, 256, 1, 72),
             "d576": (2, 256, 1, 576), "d1152": (2, 256, 1, 1152),
             "heads": (2, 256, 2, 512)}.get(case, (2, 256, 1, 512))
    dtype = torch.float32 if case == "fp32" else torch.bfloat16
    q, k, v = (torch.zeros(shape, dtype=dtype) for _ in range(3))
    if case == "stride":
        k = torch.zeros((2, 256, 1, 516), dtype=dtype)[..., :512]
    if case == "pointer":
        v = torch.zeros(2 * 256 * 512 + 4, dtype=dtype)[4:].view(2, 256, 1,
                                                                 512)
        assert v.data_ptr() % 16 == 8
    if case == "heads":
        q = torch.zeros((2, 256, 2 * 516), dtype=dtype)[:, :, :1028].view(
            2, 256, 2, 514)[..., :512]
        assert q.stride(2) % 8 == 2
    assert port_attention.takes_wgmma(q, k, v) == (case == "d576")
    aligned = torch.zeros((2, 256, 1, 512), dtype=torch.bfloat16)
    assert port_attention.takes_wgmma(aligned, aligned, aligned)


def test_whole_s_mma_smem_formulas():
    """The TMA + wgmma kernels' shared memory is within the opt-in limit
    at D = 512 and 1024: at 1024 the stats keep the 64 kept rows (16
    chunks of 64 x 64 bf16), three ring stages of 128 rows x 2 chunks and
    1 KB of (m, l), the apply Q, two P tiles and five stages of 64 rows x 2
    chunks, each with 1024 bytes of alignment slack and 512 for the
    barriers."""
    limit = port_attention.MAX_SMEM
    stats, apply = port_attention.wgmma_smem_bytes(1024)
    assert stats == 1536 + 1024 + 16 * 8192 + 3 * 32768 == 231936
    assert apply == 1536 + (16 + 2) * 8192 + 5 * 16384 == 230912
    assert port_attention.wgmma_stages(1024) == (3, 5)
    assert port_attention.wgmma_stages(512) == (5, 9)
    assert max(port_attention.wgmma_smem_bytes(512)) <= limit
    assert max(stats, apply) <= limit


def test_mirror_constants_match_the_sources():
    """The tile constants the Python mirrors use are the C sources'."""
    from sdm_tpu_torch.kernels import streaming_attention as sa
    src = ""
    for name in ("attention_tiles.cuh", "attention_kernels.cuh",
                 "linear_kernels.cuh"):
        with open(os.path.join(_build.CSRC, name)) as f:
            src += f.read()
    defines = dict(re.findall(r"#define (\w+) (\d+)", src))
    want = {"MAX_SMEM": sa.MAX_SMEM,
            "WROWS": port_attention.WGMMA_ROWS,
            "WBOX": port_attention.WGMMA_BOX,
            "WCHUNKS": port_attention.WGMMA_CHUNKS,
            "WMAX_D": port_attention.WGMMA_MAX_D,
            "WCOLS": port_attention.WGMMA_COLS,
            "WRED": port_attention.WGMMA_RED,
            "WSTATS_STAGES": port_attention.WGMMA_STATS_STAGES,
            "WAPPLY_STAGES": port_attention.WGMMA_APPLY_STAGES,
            "WSMS": port_attention.SMS,
            "WHOLE_S_MAX_MMA": port_attention.MAX_S_MMA,
            "LBK": port_block.LINEAR_BK,
            "LWG": port_block.LINEAR_TILES[0][0],
            "LBN": port_block.LINEAR_TILES[0][1],
            "LSTAGES": port_block.LINEAR_TILES[0][2],
            "LWG_SMALL": port_block.LINEAR_TILES[1][0],
            "LBN_SMALL": port_block.LINEAR_TILES[1][1],
            "LSTAGES_SMALL": port_block.LINEAR_TILES[1][2],
            "LBLOCKS": port_block.LINEAR_BLOCKS,
            "LSMS": port_block.LINEAR_SMS}
    assert {k: int(defines[k]) for k in want} == want


def test_kernel_sources_export_the_wrapped_symbols():
    """Each library's C entry point exists in its source with the argument
    count the ctypes wrapper declares, the tensor-core admissions and plans
    are exported for their Python mirrors, the WMMA attention kernels, the
    WMMA and mma.sync dK/dQ kernels, the whole-S attention's mma.sync
    kernels, the streaming forward's mma.sync stats kernel, the mma.sync
    apply and dV kernel (stream_apply_mma) and its admission, the WMMA and
    mma.sync GEMMs and every mma.sync, ldmatrix and cp.async primitive are
    gone, the TMA, mbarrier and wgmma primitives live in their headers,
    and the build targets sm_90a."""
    from sdm_tpu_torch.kernels import (adagn, attention_block,
                                       streaming_attention)
    assert {"sdm_attention_takes_wgmma", "sdm_attention_wgmma_plan",
            "sdm_attention_wgmma_smem"} <= set(port_attention._SIGNATURES)
    assert {"sdm_streaming_stats_takes_wgmma",
            "sdm_streaming_apply_takes_wgmma", "sdm_streaming_wgmma_plan",
            "sdm_streaming_wgmma_smem",
            "sdm_streaming_da_takes_wgmma",
            "sdm_streaming_da_wgmma_smem"} <= set(
                streaming_attention._SIGNATURES)
    for name in ("attention.cu", "streaming_attention.cu",
                 "attention_tiles.cuh"):
        with open(os.path.join(_build.CSRC, name)) as f:
            src = f.read()
        assert "attn_stats_wmma" not in src and "attn_apply_wmma" not in src
    # The whole-S library launches its TMA + wgmma kernels alone: no
    # mma.sync stats or apply of the streaming library, no wide apply (its
    # comments still name them, as what the new kernels replaced). They live
    # in attention_kernels.cuh, which attention.cu and attention_block.cu
    # include.
    with open(os.path.join(_build.CSRC, "attention.cu")) as f:
        assert '#include "attention_kernels.cuh"' in f.read()
    with open(os.path.join(_build.CSRC, "attention_kernels.cuh")) as f:
        src = re.sub(r"//[^\n]*", "", f.read())
    for gone in ("launch_stats_mma", "launch_apply_mma", "stream_apply_mma",
                 "attn_apply_mma_wide", "mma_plan", "launch_mma"):
        assert not re.search(r"\b" + gone + r"\b", src), gone
    assert "attn_stats_wgmma<<<" in src and "&attn_apply_wgmma<true, 4>" in src
    # The streaming library's dK/dQ kernel is TMA + wgmma: no WMMA and no
    # mma.sync dA kernel left (its comments still name the latter).
    with open(os.path.join(_build.CSRC, "streaming_attention.cu")) as f:
        src = f.read()
    assert "wmma" not in src.lower() and "<mma.h>" not in src
    assert "stream_da_wgmma<" in src
    assert not re.search(r"\bstream_da_mma\b", re.sub(r"//[^\n]*", "", src))
    # Its forward is the TMA + wgmma stats and apply, else the CUDA cores:
    # no mma.sync stats kernel, no forward on stream_apply_mma.
    for name in ("streaming_attention.cu", "attention_tiles.cuh"):
        with open(os.path.join(_build.CSRC, name)) as f:
            code = re.sub(r"//[^\n]*", "", f.read())
        assert not re.search(r"\b(attn_stats_mma|launch_stats_mma|"
                             r"stats_mma_ok)\b", code), name
    assert "launch_apply_mma<apply_pass>" not in src
    # No mma.sync kernel is left in the library: dV runs on the wgmma
    # apply, and neither the C sources (outside comments) nor the Python
    # package name the mma.sync apply, its admission or its primitives.
    for name in os.listdir(_build.CSRC):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(_build.CSRC, name)) as f:
                code = re.sub(r"//[^\n]*", "", f.read())
            for gone in ("stream_apply_mma", "launch_apply_mma",
                         "stream_mma_ok", "stream_mma_smem_bytes",
                         "sdm_streaming_apply_takes_mma",
                         "sdm_streaming_mma_smem_bytes", "mma_bf16",
                         "ldsm_x4", "ldsm_x4_trans", "cp_async16",
                         "cp_async_rows", "MMAXD"):
                assert not re.search(r"\b" + gone + r"\b", code), (name, gone)
    assert "mma_tiles.cuh" not in os.listdir(_build.CSRC)
    package = os.path.dirname(_build.CSRC)
    for root, _, files in os.walk(package):
        for name in files:
            if name.endswith((".py", ".cu", ".cuh")):
                with open(os.path.join(root, name)) as f:
                    text = f.read()
                for gone in ("apply_takes_mma", "apply_admits_mma",
                             "apply_smem_bytes_mma", "MMA_MAX_D",
                             "MMA_QUERIES", "MMA_KEYS"):
                    assert not re.search(r"\b" + gone + r"\b", text), (
                        name, gone)
    assert not hasattr(streaming_attention, "apply_takes_mma")
    assert {"sdm_linear_takes_wgmma", "sdm_linear_wgmma_tile"} <= set(
        attention_block._SIGNATURES)
    # The GEMM is the TMA + wgmma kernel alone: no mma.sync GEMM is left.
    # It lives in linear_kernels.cuh, which linear.cu and attention_block.cu
    # include.
    with open(os.path.join(_build.CSRC, "linear.cu")) as f:
        assert '#include "linear_kernels.cuh"' in f.read()
    with open(os.path.join(_build.CSRC, "linear_kernels.cuh")) as f:
        src = f.read()
    assert "linear_wmma" not in src and "wmma" not in src
    assert '#include "wgmma_tiles.cuh"' in src and "linear_wgmma<" in src
    for gone in ("launch_linear_mma", "mma_bf16(", "ldsm_x4", "cp_async16"):
        assert gone not in src, gone
    for name in os.listdir(_build.CSRC):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(_build.CSRC, name)) as f:
                src = f.read()
            # One copy of each primitive: the TMA-map and wgmma ones in
            # wgmma_tiles.cuh, the mbarrier, bulk-copy, proxy-fence and
            # device-counter ones in async_tiles.cuh; no mma.sync, ldmatrix
            # or cp.async one anywhere.
            for primitive in ('"mma.sync.aligned', '"ldmatrix.sync',
                              '"cp.async.cg.shared', '"cp.async.ca.shared',
                              "void cp_async_rows("):
                assert primitive not in src, (name, primitive)
            for primitive in ('"wgmma.mma_async', '"wgmma.fence',
                              '"wgmma.commit_group', '"wgmma.wait_group',
                              '"cp.async.bulk.tensor', "cuTensorMapEncodeTiled",
                              "uint64_t wgmma_desc(",
                              "void quad_transpose4("):
                assert (primitive in src) == (name == "wgmma_tiles.cuh"), (
                    name, primitive)
            for primitive in ('"mbarrier.init', '"mbarrier.arrive',
                              '"mbarrier.try_wait', '"fence.mbarrier_init',
                              '"fence.proxy.async', '"createpolicy',
                              '"cp.async.bulk.shared::cluster.global',
                              '"cp.async.bulk.global.shared',
                              '"cp.async.bulk.commit_group',
                              '"atom.add.release.gpu', '"ld.acquire.gpu'):
                assert (primitive in src) == (name == "async_tiles.cuh"), (
                    name, primitive)
    for name, sigs in (("adagn", adagn._SIGNATURES),
                       ("attention", port_attention._SIGNATURES),
                       ("attention_block", attention_block._BLOCK_SIGNATURES),
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
    assert set(_build.SOURCES) == {"adagn", "attention", "attention_block",
                                   "linear", "streaming_attention"}


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
        mma_before = fused_attention.mma_launches
        got = wrapper(*args)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        if wrapper is fused_attention:
            assert fused_attention.mma_launches == mma_before + (
                port_attention.takes_wgmma(*args[:3]))
        want = plain(*args).float()
        tol = (dict(atol=1e-4, rtol=1e-3) if dtype == torch.float32
               else attn_bf16_tol(_np(want)) if wrapper is fused_attention
               else BF16)
        torch.testing.assert_close(got.float(), want, **tol)
