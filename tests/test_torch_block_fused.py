"""The attention block's one C call (sdm_tpu_torch/csrc/attention_block.cu),
on the CPU.

`sdm_attention_block_forward` launches every kernel of a whole-S block; at
bf16, d_k = C = 512, S >= BFUSED_MIN_S its apply carries the output
projection (`attn_apply_wgmma<axis, 4, true>`, csrc/attention_kernels.cuh),
so no r tensor exists. The CUDA cannot run here, so this file holds:

- the route mirror (`block_route`, `block_takes_fused_out`) and the scratch
  sizes at every whole-S shape of the flagship 128x128 and the SR 256x256
  U-Net, batch 1, 2, 16 and 32, against values written out;
- an emulation of the fused epilogue: the apply's r rounded to bf16 and
  stored into Q's buffer as the kernel stores it, W_out streamed as the
  ring's 128-row loads and read through the kernel's descriptors, the
  products in the kernel's K order, b_out added in fp32, rounded, then the
  residual added in bf16; held to `attention_block_reference` and to
  sdm_tpu's `fused_attention_block` in interpret mode, and a variant that
  adds the residual before rounding must fail;
- `_launch_block` with the library and the device checks replaced by
  recorders: one library call per whole-S block, with the pointers,
  sizes and codes the C entry reads.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdm_tpu.kernels.attention_block import \
    fused_attention_block as jax_fused_attention_block
from sdm_tpu_torch.kernels import _build
from sdm_tpu_torch.kernels import attention_block as ab
from sdm_tpu_torch.kernels import attention as attn

BOX = 64                # columns of a chunk, a 128-byte swizzled row
CHUNK_BYTES = 64 * BOX * 2
W_ROWS = 128            # W_out rows a ring load: 64 a warpgroup
BASE = 1024             # the aligned dynamic shared memory
BF = torch.bfloat16

# Every whole-S (S, C) block of the flagship and the SR U-Net (d_k = C),
# with its route at bf16 and the scratch elements a sample: qkv (S, 3 C)
# and, off the fused route, r (S, C).
WHOLE_S = {(1024, 512): (2, 1024 * 3 * 512),
           (256, 512): (1, 256 * 4 * 512),
           (64, 1024): (1, 64 * 4 * 1024),
           (256, 1024): (1, 256 * 4 * 1024),
           (1024, 1024): (1, 1024 * 4 * 1024)}

# fp32 against the plain version and sdm_tpu: fp32 sums in another order.
FP32 = dict(atol=2e-5, rtol=2e-4)


def _meta(*shape, dtype=BF):
    return torch.empty(shape, dtype=dtype, device="meta")


# --------------------------------------------------------- route and sizes

@pytest.mark.parametrize("n", [1, 2, 16, 32])
@pytest.mark.parametrize("shape", sorted(WHOLE_S))
def test_route_and_scratch_at_the_unet_shapes(n, shape):
    """bf16: the fused route at (1024, 512) alone, four tensor-core
    launches elsewhere, whatever the batch; fp32 takes the CUDA cores. The
    scratch holds qkv, and r off the fused route."""
    s, c = shape
    route, per_sample = WHOLE_S[shape]
    tok, w_qkv, w_out = _meta(n, s, c), _meta(3 * c, c), _meta(c, c)
    assert ab.block_route(BF, n, s, c, c, (0,) * 5) == route
    assert ab.block_takes_fused_out(tok, w_qkv, w_out) == (route == 2)
    assert ab.block_scratch_elems(n, s, c, route) == n * per_sample
    assert ab.block_route(torch.float32, n, s, c, c, (0,) * 5) == 0
    assert ab.block_scratch_elems(n, s, c, 0) == n * s * 4 * c


@pytest.mark.parametrize("case", ["short", "d_k", "c", "ragged", "w_out",
                                  "out", "tokens", "scratch", "long"])
def test_route_refuses_off_the_fused_shapes(case):
    """Each condition of the fused route on its own: S below BFUSED_MIN_S,
    d_k or C other than 512, S off the 64-row grid (CUDA cores), W_out or
    the output off 16 bytes (four launches), the tokens or the scratch off
    16 bytes or S past the whole-S limit (CUDA cores); W_out off 16 bytes
    also sends the output projection to the CUDA cores."""
    n, s, c, d = 2, 1024, 512, 512
    ptrs = [0] * 5
    want = {"short": 1, "d_k": 1, "c": 1, "ragged": 0, "w_out": 0,
            "out": 1, "tokens": 0, "scratch": 0, "long": 0}[case]
    if case == "short":
        s = ab.BFUSED_MIN_S - 64
    elif case == "d_k":
        d = 256
    elif case == "c":
        c = 1024
    elif case == "ragged":
        s = 1000
    elif case == "long":
        s = 4096
    else:
        ptrs[("tokens", "w_qkv", "w_out", "out", "scratch").index(case)] = 8
    assert ab.block_route(BF, n, s, c, d, ptrs) == want
    assert ab.block_route(BF, n, 1024, 512, 512, [0] * 5) == 2


# ------------------------------------------------------ the fused epilogue

def _swizzled(bits):
    """The image of a (rows, 64) bf16 tile (int16 bit patterns) in the
    128B-swizzled layout: row r at byte 128 r, its 16-byte unit u at
    u ^ (r % 8)."""
    rows = bits.shape[0]
    r = torch.arange(rows)[:, None]
    c = torch.arange(BOX)[None, :]
    byte = r * 128 + (((2 * c) // 16) ^ (r % 8)) * 16 + (2 * c) % 16
    img = torch.zeros(rows * BOX, dtype=torch.int16)
    img[(byte // 2).reshape(-1)] = bits.reshape(-1)
    return img


def _desc(addr):
    """wgmma_tiles.cuh's wgmma_desc: a K-major 128B-swizzled tile."""
    return ((addr & 0x3FFFF) >> 4) | (1 << 16) | (64 << 32) | (1 << 62)


def _operand_k(smem, desc, rows):
    """The rows x 16 bf16 (bit patterns) a K-major descriptor names:
    element (i, j) at start + 1024 (i // 8) + 128 (i % 8) + 2 j, bits 4-6
    of the address XOR bits 7-9."""
    start = (desc & 0x3FFF) << 4
    i = torch.arange(rows)[:, None]
    j = torch.arange(16)[None, :]
    addr = start + (i // 8) * 1024 + (i % 8) * 128 + 2 * j
    return smem[(addr ^ (((addr >> 7) & 7) << 4)) // 2]


def _f32(bits):
    return bits.view(BF).float()


def _fragments():
    """(row, col) of accumulator i of warpgroup thread t for m64n64, each
    (128, 32): warp w = t // 32, lane 4 g + q; d[4 j + e] at row 16 w + g +
    8 (e // 2), column 8 j + 2 q + e % 2."""
    t = torch.arange(128)[:, None]
    i = torch.arange(32)[None, :]
    g, q = (t % 32) // 4, t % 4
    j, e = i // 4, i % 4
    return 16 * (t // 32) + g + 8 * (e // 2), 8 * j + 2 * q + e % 2


def emulate_fused_out(r32, w_out, b_out, res, total=0,
                      residual_first=False):
    """attn_apply_wgmma<axis, NB, true>'s epilogue for one 64-row tile:
    r32 (64, d_k) fp32 (the apply's accumulators), w_out (C, d_k), b_out
    (C,), res (64, C) in the compute dtype; `total` the attention's ring
    steps before the projection's. NB = C / 128 slots a warpgroup: slot b of
    warpgroup wg holds r's chunk 2 b + wg and then the output's. In bf16
    every operand goes through the kernel's shared memory: r stored pair by
    pair into Q's buffer, W_out's 128 x 64 boxes into the ring's stages
    (step x in stage x % stages), both read through wgmma_desc; fp32 takes
    the same products and order on the values. Returns (64, C)."""
    dtype = res.dtype
    d_k, c = r32.shape[1], w_out.shape[0]
    nb = c // W_ROWS
    assert c == 2 * nb * BOX and d_k % BOX == 0
    rows, cols = _fragments()
    t = torch.arange(128)
    w, g, tg = t // 32, (t % 32) // 4, t % 4
    q_at = BASE
    ring_at = q_at + (d_k // BOX + 2) * CHUNK_BYTES
    stages = attn.wgmma_stages(d_k)[1]
    smem = torch.zeros((ring_at + stages * 2 * CHUNK_BYTES) // 2,
                       dtype=torch.int16)
    r = r32.to(dtype)
    if dtype == BF:
        # r rounded to bf16 into Q's buffer as the kernel stores it: chunk
        # 2 b + wg at byte 128 (16 w + g + 8 hh) + ((j ^ g) << 4) + 4 tg of
        # its tile.
        r_bits = r.view(torch.int16)
        for wg in range(2):
            for b in range(nb):
                chunk = 2 * b + wg
                frag = r_bits[:, BOX * chunk:BOX * chunk + BOX][rows, cols]
                for j in range(8):
                    for hh in range(2):
                        byte = (q_at + chunk * CHUNK_BYTES
                                + (16 * w + g + 8 * hh) * 128
                                + ((j ^ g) << 4) + 4 * tg)
                        smem[byte // 2] = frag[:, 4 * j + 2 * hh]
                        smem[byte // 2 + 1] = frag[:, 4 * j + 2 * hh + 1]
    # W_out through the ring: step total + kc nb + p loads rows 128 p ..
    # and K chunk kc (a 128 x 64 swizzled box); warpgroup wg's slot p reads
    # its rows 64 wg .. (K-major), A the r chunk kc, 16-deep steps in order.
    acc = torch.zeros((2, nb, 128, 32))
    for kc in range(d_k // BOX):
        for p in range(nb):
            box = w_out[W_ROWS * p:W_ROWS * p + W_ROWS,
                        BOX * kc:BOX * kc + BOX]
            stage = ring_at + ((total + kc * nb + p) % stages) * 2 * CHUNK_BYTES
            if dtype == BF:
                smem[stage // 2:stage // 2 + W_ROWS * BOX] = _swizzled(
                    box.contiguous().view(torch.int16))
            for wg in range(2):
                prod = torch.zeros((64, 64))
                for kk in range(BOX // 16):
                    if dtype == BF:
                        a = _f32(_operand_k(
                            smem, _desc(q_at + kc * CHUNK_BYTES) + 2 * kk,
                            64))
                        bt = _f32(_operand_k(
                            smem, _desc(stage + wg * CHUNK_BYTES) + 2 * kk,
                            64))
                    else:
                        k0 = BOX * kc + 16 * kk
                        a = r[:, k0:k0 + 16].float()
                        bt = box[64 * wg:64 * wg + 64,
                                 16 * kk:16 * kk + 16].float()
                    prod += a @ bt.T
                acc[wg, p] += prod[rows, cols]
    out = torch.zeros((64, c))
    for wg in range(2):
        for p in range(nb):
            col = BOX * (2 * p + wg) + cols
            y = acc[wg, p] + b_out.float()[col]
            if residual_first:
                y = (y + res.float()[rows, col]).to(dtype).float()
            else:
                y = y.to(dtype).float() + res.float()[rows, col]
            out[rows, col] = y
    return out.to(dtype)


def emulate_block(tok, w_qkv, b_qkv, w_out, b_out, scale, axis,
                  residual_first=False):
    """The fused route of one block: qkv by the GEMM (linear_reference's
    rounding), r as the apply accumulates it (fp32 P V of P rounded to
    bf16), then emulate_fused_out tile by tile."""
    n, s, c = tok.shape
    d_k = w_out.shape[1]
    tok2 = tok.reshape(n * s, c)
    qkv = ab.linear_reference(tok2, w_qkv, b_qkv).view(n, s, 1, 3 * d_k)
    q, k, v = qkv.split(d_k, dim=-1)
    scores = torch.matmul(q[:, :, 0].float(),
                          k[:, :, 0].float().transpose(1, 2)) * scale
    p = torch.softmax(scores, dim=1 if axis == "q" else 2).to(tok.dtype)
    r32 = torch.matmul(p.float(), v[:, :, 0].float())       # (n, s, d_k)
    # The apply's ring steps before the projection: per key tile, the K
    # loads of D and the V loads of the block's D columns (two chunks each).
    total = (s // 64) * 2 * (d_k // (2 * BOX))
    out = torch.empty((n, s, c), dtype=tok.dtype)
    for i in range(n):
        for i0 in range(0, s, 64):
            out[i, i0:i0 + 64] = emulate_fused_out(
                r32[i, i0:i0 + 64], w_out, b_out, tok[i, i0:i0 + 64], total,
                residual_first)
    return out


def _inputs(seed, n, s, c, dtype):
    """Seeded block inputs in nn.Linear layout (tokens of std 1.5, weights
    and biases uniform in +-1/sqrt(C) as the layer's init), fp32 biases."""
    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(c)
    a = [1.5 * rng.standard_normal((n, s, c)),
         rng.uniform(-bound, bound, (3 * c, c)),
         rng.uniform(-bound, bound, 3 * c),
         rng.uniform(-bound, bound, (c, c)),
         rng.uniform(-bound, bound, c)]
    a = [x.astype(np.float32) for x in a]
    t = [torch.from_numpy(x) for x in a]
    return a, (t[0].to(dtype), t[1].to(dtype), t[2], t[3].to(dtype), t[4])


def _bf16_ulp(x):
    """One bf16 ulp at each element (2^-7 of its binade)."""
    x = np.maximum(np.abs(np.asarray(x, np.float32)), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(x)) - 7)


def _bf16_agrees(got, want):
    """bf16 against the plain version: both round qkv, P, r, the projection
    and the sum with the residual at the same points, so only an fp32 sum
    taken in another order can flip a rounding: every element within one
    ulp of the larger of |output| and |output - residual part|'s bound (two
    ulps of the output), and at most 0.1 % of the elements differ at all.
    The wrong rounding order (residual before rounding) differs in about 7
    % of them."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    diff = np.abs(got - want)
    return (bool((diff <= 2 * _bf16_ulp(want)).all())
            and float((diff > 0).mean()) <= 1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis", ["q", "k"])
def test_fused_epilogue_matches_the_plain_block(dtype, axis):
    """Batch 2, S = 128, C = d_k = 128 (one slot a warpgroup, two K
    chunks): the emulated fused route against `attention_block_reference`
    (fp32: FP32; bf16: `_bf16_agrees`), and the variant that adds the
    residual before rounding against it, which must fail in bf16."""
    dt = getattr(torch, dtype)
    _, args = _inputs(3 + (axis == "q"), 2, 128, 128, dt)
    scale = 128 ** -0.5
    got = emulate_block(*args, scale, axis)
    want = ab.attention_block_reference(*args, scale, axis)
    assert got.dtype == want.dtype == dt
    if dt == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), **FP32)
        return
    assert _bf16_agrees(got.float(), want.float())
    wrong = emulate_block(*args, scale, axis, residual_first=True)
    assert not _bf16_agrees(wrong.float(), want.float())


@pytest.fixture
def interpret(monkeypatch):
    from jax.experimental.pallas import tpu as pltpu
    monkeypatch.setenv("SDM_TPU_PALLAS_INTERPRET", "1")
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis", ["q", "k"])
def test_fused_epilogue_matches_sdm_tpu(interpret, dtype, axis):
    """The same emulation against sdm_tpu's `fused_attention_block` (its
    Pallas kernel in interpret mode; flax weight layout), batch 2, S = 128,
    C = d_k = 128. fp32: FP32. bf16: the TPU kernel's fp32 scores and
    softmax differ from the emulation's in the last bits, which can flip a
    bf16 P entry and move an output by an amount set by the output's
    scale: 1e-2 of the element plus 1e-2 of the largest output."""
    dt = getattr(torch, dtype)
    a, args = _inputs(5 + (axis == "q"), 2, 128, 128, dt)
    scale = 128 ** -0.5
    got = emulate_block(*args, scale, axis).float().numpy()
    jdt = jnp.float32 if dt == torch.float32 else jnp.bfloat16
    ref = np.asarray(jax_fused_attention_block(
        jnp.asarray(a[0], jdt), jnp.asarray(a[1].T), jnp.asarray(a[2]),
        jnp.asarray(a[3].T), jnp.asarray(a[4]), scale, axis), np.float32)
    tol = FP32 if dt == torch.float32 else dict(
        atol=1e-2 * float(np.abs(ref).max()), rtol=1e-2)
    np.testing.assert_allclose(got, ref, **tol)


@pytest.mark.parametrize("axis", ["q", "k"])
def test_fused_epilogue_at_the_kernel_width(axis):
    """The kernel's own instantiation, NB = 4: one 64-row tile at C = d_k =
    512 (four slots a warpgroup, eight K chunks, 32 ring loads of W_out),
    bf16, against `attention_block_reference` as above."""
    _, args = _inputs(9 + (axis == "q"), 1, 64, 512, BF)
    scale = 512 ** -0.5
    got = emulate_block(*args, scale, axis)
    want = ab.attention_block_reference(*args, scale, axis)
    assert _bf16_agrees(got.float(), want.float())


def test_r_tile_reads_back_through_the_descriptors():
    """The layout alone, bit for bit: r stored pair by pair into Q's buffer
    reads back through wgmma_desc(Q chunk kc) + 2 kk as r's columns 64 kc +
    16 kk ..; a 128-row W_out box read at stage + 8 KB wg gives rows 128 p
    + 64 wg ..; with the swizzle's XOR dropped from the store, the read
    differs."""
    rng = np.random.default_rng(1)
    r = torch.from_numpy(rng.standard_normal((64, 512)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((512, 512)).astype(np.float32))
    rows, cols = _fragments()
    exact = emulate_fused_out(r, w.to(BF), torch.zeros(512),
                              torch.zeros((64, 512), dtype=BF), total=5)
    want = (r.to(BF).float() @ w.to(BF).float().T).to(BF)
    # fp32 sums of 512 products in 16-deep steps against one matmul: the
    # same bf16 value but where an fp32 last bit flips a rounding.
    assert float((exact.float() != want.float()).float().mean()) <= 1e-3
    # A row of W_out read as another (rows 64 wg .. of the wrong box) or r
    # stored unswizzled changes the product.
    box = w.to(BF).view(torch.int16)[:W_ROWS, :BOX]
    img = _swizzled(box)
    smem = torch.zeros(2 * CHUNK_BYTES // 2 + BASE, dtype=torch.int16)
    smem[BASE // 2:BASE // 2 + img.numel()] = img
    for wg in range(2):
        for kk in range(4):
            got = _operand_k(smem, _desc(BASE + wg * CHUNK_BYTES) + 2 * kk, 64)
            assert torch.equal(got, box[64 * wg:64 * wg + 64,
                                        16 * kk:16 * kk + 16])
    flat = torch.zeros_like(smem)
    flat[BASE // 2:BASE // 2 + box.numel()] = box.reshape(-1)
    assert not torch.equal(_operand_k(flat, _desc(BASE), 64),
                           box[:64, :16])
    del rows, cols


# ------------------------------------------------------------ the wrapper

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_launch_block_makes_one_call(monkeypatch, dtype):
    """At whole-S shapes `_launch_block` checks its operands and makes one
    library call: the tokens', weights', biases' and output's pointers, the
    biases' dtype codes, a scratch of `block_scratch_elems` for the route,
    2 N S fp32 stats, N, S, C, d_k, the scale, the axis and the dtype
    code; `wgmma_launches` and `fused_out_launches` move as the route says,
    `linear` does not."""
    calls, checked = [], []

    class Lib:
        def sdm_attention_block_forward(self, *args):
            calls.append(args)
            return 0
    monkeypatch.setattr(_build, "library", lambda name, sigs: (
        calls.append(name) or Lib()))
    monkeypatch.setattr(_build, "require_cuda",
                        lambda what, *t: checked.append((what, len(t))))
    monkeypatch.setattr(_build, "on_device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(_build, "stream_handle", lambda d: 7)
    fab = ab.fused_attention_block
    for name in ("wgmma_launches", "fused_out_launches"):
        monkeypatch.setattr(fab, name, 0)
    linear_before = ab.linear.launches
    dt = getattr(torch, dtype)
    code = _build.DTYPE_CODES[dt]
    for (s, c), axis in (((1024, 512), "q"), ((256, 512), "k"),
                         ((64, 1024), "q")):
        n = 2
        tok = torch.empty((n, s, c), dtype=dt)
        w_qkv, w_out = torch.empty((3 * c, c), dtype=dt), torch.empty(
            (c, c), dtype=dt)
        b_qkv, b_out = torch.empty(3 * c), torch.empty(c, dtype=dt)
        before = len(calls)
        out = ab._launch_block(tok, w_qkv, b_qkv, w_out, b_out, 0.125, axis)
        assert calls[before] == "attention_block"
        assert len(calls) == before + 2
        args = calls[-1]
        route = WHOLE_S[(s, c)][0] if dt == BF else 0
        assert args[:9] == (tok.data_ptr(), w_qkv.data_ptr(),
                            b_qkv.data_ptr(), 0, w_out.data_ptr(),
                            b_out.data_ptr(), code, out.data_ptr(), args[8])
        assert args[9] == ab.block_scratch_elems(n, s, c, route)
        assert args[11:] == (n, s, c, c, 0.125, int(axis == "q"), code, 7)
        assert out.shape == tok.shape and out.dtype == dt
    assert checked == [("fused_attention_block", 5)] * 3
    want_wgmma = 3 if dt == BF else 0
    assert fab.wgmma_launches == want_wgmma
    assert fab.fused_out_launches == (1 if dt == BF else 0)
    assert ab.linear.launches == linear_before


def test_launch_block_refuses_mismatched_operands(monkeypatch):
    """Weights off the tokens' dtype, a transposed W_out or a wrong axis
    are refused before any library call."""
    monkeypatch.setattr(_build, "require_cuda", lambda *a: None)
    monkeypatch.setattr(_build, "library", lambda *a: pytest.fail("called"))
    tok = torch.empty((1, 64, 128), dtype=BF)
    w_qkv, w_out = torch.empty((384, 128), dtype=BF), torch.empty(
        (128, 128), dtype=BF)
    b_qkv, b_out = torch.empty(384), torch.empty(128)
    for bad in ({"w_qkv": w_qkv.float()}, {"w_out": w_out.t()},
                {"axis": "x"}, {"b_out": torch.empty(64)}):
        kw = dict(w_qkv=w_qkv, b_qkv=b_qkv, w_out=w_out, b_out=b_out,
                  axis="q")
        kw.update(bad)
        with pytest.raises(ValueError):
            ab._launch_block(tok, kw["w_qkv"], kw["b_qkv"], kw["w_out"],
                             kw["b_out"], 0.1, kw["axis"])
