"""The port's bf16 whole-S attention, `attn_stats_wgmma` and
`attn_apply_wgmma` (csrc/attention_kernels.cuh), on the CPU.

The kernels run only on a card. Here: their admission, column split and
shared memory (the Python mirrors in kernels/attention.py, which
chip_smoke.py holds to the C exports) at every U-Net shape and off them,
and an emulation of both kernels' data movement in plain PyTorch: the TMA
loads of the rank-5 (64 columns, S, D/64 chunks, H, N) maps, two swizzled
64-column chunks a load, written into the rings in the 128-byte swizzled
layout (zero past S and D), the wgmma operands read back through the
matrix descriptors as wgmma_tiles.cuh encodes them (K-major Q, K, kept and
reduced rows and P; V MN-major through the transpose-B bit), the
accumulator fragments, the per-row or per-key (m, l) in the log2 scale, P
normalised (exp2 times a reciprocal) and then rounded to bf16 and stored
into the swizzled P tile at the addresses the kernel computes, the P V
products slot by slot and the quad-transposed epilogue. On inputs whose fp32 sums are exact in any order, the emulation
must give `attention_reference` bit for bit on both softmax axes.
"""

import functools
import os
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdm_tpu.kernels.attention import _xla_attention
from sdm_tpu_torch.kernels import _build
from sdm_tpu_torch.kernels import attention as attn
from sdm_tpu_torch.kernels.attention import attention_reference

BOX = attn.WGMMA_BOX            # columns of D a chunk
ROWS = attn.WGMMA_ROWS          # kept rows / queries a block, keys a tile
RED = attn.WGMMA_RED            # reduced rows a stats load
CHUNKS = attn.WGMMA_CHUNKS      # chunks a TMA load
BOX_BYTES = ROWS * BOX * 2      # a 64 x 64 chunk
LOAD = CHUNKS * BOX_BYTES       # a 64-row load
LOG2E = 1.4426950408889634
BASE = 1024                     # the aligned dynamic shared memory

# (S, D) of the whole-S attention blocks of the flagship 128x128 and the SR
# 256x256 U-Net at batch 16 (chip_smoke.py BLOCK_SHAPES, SR_BLOCK_SHAPES),
# then chip_smoke.py's EXTRA_SHAPES, with csrc/attention_kernels.cuh's
# wgmma_plan for each: (split, columns a block).
UNET_PLANS = {(1024, 512): (1, 512), (256, 512): (2, 256),
              (64, 1024): (8, 128), (256, 1024): (2, 512),
              (1024, 1024): (2, 512), (256, 128): (2, 64),
              (256, 384): (2, 192), (1024, 768): (2, 384),
              (64, 128): (2, 64)}


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------- the mirrors

@pytest.mark.parametrize("shape", sorted(UNET_PLANS))
@pytest.mark.parametrize("heads", [1, 4])
def test_wgmma_admits_the_unet_shapes(shape, heads):
    """Every whole-S shape runs on the TMA + wgmma path in bf16, with q, k
    and v as strided views of one qkv buffer (one head, as the attention
    block passes them, and four)."""
    s, d = shape
    q, k, v = _meta((16, s, heads, 3 * d)).split(d, dim=-1)
    assert attn.takes_wgmma(q, k, v) and attn.whole_s_ok(q, k, v)
    assert not attn.takes_wgmma(*(t.float() for t in (q, k, v)))


@pytest.mark.parametrize("shape", sorted(UNET_PLANS))
def test_wgmma_plan_at_the_unet_shapes(shape):
    """The column split by cost: whole 64-column chunks, at most 512
    columns a block (two warpgroups of at most 256 fp32 columns), the
    slices covering D, and no split of lower cost (D + cols a block over the
    waves of one block an SM on 132 SMs)."""
    s, d = shape
    split, cols = attn.wgmma_plan(16, s, d)
    assert (split, cols) == UNET_PLANS[shape]
    assert cols % 64 == 0 and cols <= 512
    assert (split - 1) * cols < d <= split * cols

    def cost(sp):
        per = -(-(d // 64) // sp)
        return -(-16 * (s // 64) * sp // 132) * (d // 64 + per)
    assert all(cost(sp) >= cost(split)
               for sp in range(-(-d // 512), d // 64 + 1))


@pytest.mark.parametrize("d", [64, 128, 192, 512, 576, 768, 1024, 1088])
def test_wgmma_smem_within_the_opt_in_limit(d):
    """Both kernels' shared memory: the resident tile (D/64 chunks of 64 x
    64 bf16, rounded up to whole two-chunk loads), the ring (loads of 128
    or 64 rows x 2 chunks), the stats' (m, l) of two warpgroups, the
    apply's two P tiles, alignment slack and barriers, at most 232,448
    bytes; D past 1024 is refused, however it fits."""
    stats, apply = attn.wgmma_smem_bytes(d)
    s_st, a_st = attn.wgmma_stages(d)
    chunks = -(-d // 128) * 2
    assert stats == 1536 + 1024 + chunks * 8192 + s_st * 32768
    assert apply == 1536 + (chunks + 2) * 8192 + a_st * 16384
    assert max(stats, apply) <= attn.MAX_SMEM
    # The apply ring holds a 512-column slice's four V loads at once: a
    # warpgroup issues all its slots before it retires the first.
    assert a_st >= 4 and s_st >= 2
    assert attn.admits_wgmma(torch.bfloat16, 256, d, [0] * 4,
                             [(0, 0, 0)] * 4) == (d <= 1024)
    if d == 1024:
        assert (stats, apply, s_st, a_st) == (231936, 230912, 3, 5)


@pytest.mark.parametrize("case", ["fp32", "s100", "s3264", "d72", "d96",
                                  "d1152", "stride", "head_stride",
                                  "pointer"])
def test_wgmma_refuses_off_grid(case):
    """fp32, S % 64 != 0, D % 64 != 0 or past 1024, a row or a head stride
    that is not a multiple of 8 elements (no 16-byte TMA stride), and a
    pointer off 16 bytes are refused; S = 3264 is admitted, and refused
    by `fits` (the streaming kernel takes it)."""
    shape = {"s100": (2, 100, 1, 512), "s3264": (1, 3264, 1, 128),
             "d72": (2, 256, 1, 72), "d96": (2, 256, 1, 96),
             "d1152": (2, 256, 1, 1152)}.get(case, (2, 256, 1, 512))
    dtype = torch.float32 if case == "fp32" else torch.bfloat16
    q, k, v = (torch.zeros(shape, dtype=dtype) for _ in range(3))
    if case == "stride":
        k = torch.zeros((2, 256, 1, 516), dtype=dtype)[..., :512]
    if case == "head_stride":
        q = torch.zeros((2, 256, 2 * 516), dtype=dtype)[:, :, :1028].view(
            2, 256, 2, 514)[..., :512]
        k = v = torch.zeros((2, 256, 2, 512), dtype=dtype)
    if case == "pointer":
        v = torch.zeros(2 * 256 * 512 + 4, dtype=dtype)[4:].view(
            2, 256, 1, 512)
        assert v.data_ptr() % 16 == 8
    if case == "s3264":
        assert attn.takes_wgmma(q, k, v) and not attn.whole_s_ok(q, k, v)
        return
    assert not attn.takes_wgmma(q, k, v)


# ------------------------------------------------------------ the emulation

def _tma_box(x, d0, h, s0, n, rows):
    """The image (int16 bit patterns, one per bf16) TMA writes for one
    64-column chunk of x (N, S, H, D) bf16 at (d0, h, s0, n): `rows` rows
    of S x 64 columns of D, zero past S and D, 128B-swizzled: row r at byte
    128 r, its 16-byte chunk c at chunk c ^ (r % 8)."""
    _, s, _, d = x.shape
    plane = x[n, :, h, :].contiguous().view(torch.int16)   # (S, D)
    r = torch.arange(rows)[:, None]
    c = torch.arange(BOX)[None, :]
    gr, gc = s0 + r, d0 + c
    valid = (gr < s) & (gc < d)
    vals = torch.where(valid, plane[gr.clamp(max=s - 1), gc.clamp(max=d - 1)],
                       torch.zeros((), dtype=torch.int16))
    byte = r * 128 + (((2 * c) // 16) ^ (r % 8)) * 16 + (2 * c) % 16
    img = torch.zeros(rows * BOX, dtype=torch.int16)
    img[(byte // 2).reshape(-1)] = vals.reshape(-1)
    return img


def _tma_load(x, s0, chunk0, h, n, rows):
    """One load of the rank-5 map (sdm_tma_map_chunks): WGMMA_CHUNKS chunks
    of `rows` rows from chunk chunk0 on, one swizzled tile after the other
    (a chunk past D all zeros)."""
    return torch.cat([_tma_box(x, (chunk0 + i) * BOX, h, s0, n, rows)
                      for i in range(CHUNKS)])


def _put(smem, addr, img):
    smem[addr // 2:addr // 2 + img.numel()] = img


def _desc(addr, sbo=1024):
    """wgmma_tiles.cuh's wgmma_desc: a K-major 128B-swizzled tile."""
    return (((addr & 0x3FFFF) >> 4) | (1 << 16) | ((sbo >> 4) << 32)
            | (1 << 62))


def _desc_mn(addr, lbo=1024, sbo=1024):
    """wgmma_tiles.cuh's wgmma_desc_mn: an MN-major 128B-swizzled tile."""
    return (((addr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16)
            | ((sbo >> 4) << 32) | (1 << 62))


def _swizzle(addr):
    return addr ^ (((addr >> 7) & 7) << 4)


@functools.lru_cache(maxsize=None)
def _index_k(desc, rows, swizzle):
    assert desc >> 62 == 1
    start = (desc & 0x3FFF) << 4
    sbo = ((desc >> 32) & 0x3FFF) << 4
    i = torch.arange(rows)[:, None]
    j = torch.arange(16)[None, :]
    return swizzle(start + (i // 8) * sbo + (i % 8) * 128 + 2 * j) // 2


def _operand_k(smem, desc, rows):
    """The rows x 16 bf16 (bit patterns) wgmma reads through a K-major
    128B-swizzle descriptor: element (i, j) at start + (i // 8) SBO +
    128 (i % 8) + 2 j, bits 4-6 of the address XOR bits 7-9."""
    return smem[_index_k(desc, rows, _swizzle)]


@functools.lru_cache(maxsize=None)
def _index_mn(desc, cols, swizzle):
    assert desc >> 62 == 1
    start = (desc & 0x3FFF) << 4
    lbo = ((desc >> 16) & 0x3FFF) << 4
    sbo = ((desc >> 32) & 0x3FFF) << 4
    n = torch.arange(cols)[:, None]
    k = torch.arange(16)[None, :]
    addr = (start + 2 * (n % 64) + 128 * (k % 8) + lbo * (n // 64)
            + sbo * (k // 8))
    return swizzle(addr) // 2


def _operand_mn(smem, desc, cols):
    """The cols x 16 B operand (element (n, k), bit patterns) wgmma reads
    through an MN-major 128B-swizzle descriptor, PTX's canonical layout
    ((8, 8, m), (8, k)) : ((1, 8, LBO), (64, SBO)) in elements: (n, k) at
    start + 2 (n % 64) + 128 (k % 8) + LBO (n // 64) + SBO (k // 8),
    swizzled."""
    return smem[_index_mn(desc, cols, _swizzle)]


def _b_operand(smem, desc, cols, trans_b):
    """B as the transpose-B bit makes wgmma read it: MN-major when set,
    K-major (the same bytes taken as cols rows of 16) when clear."""
    return (_operand_mn(smem, desc, cols) if trans_b
            else _operand_k(smem, desc, cols))


def _f32(bits):
    return bits.view(torch.bfloat16).float()


def _fragments(n):
    """(row, col) of accumulator i of warpgroup thread t, each (128, n / 2):
    warp w = t // 32, lane 4 g + q; d[4 j + e] at row 16 w + g + 8 (e // 2),
    column 8 j + 2 q + e % 2."""
    t = torch.arange(128)[:, None]
    i = torch.arange(n // 2)[None, :]
    g, q = (t % 32) // 4, t % 4
    j, e = i // 4, i % 4
    return 16 * (t // 32) + g + 8 * (e // 2), 8 * j + 2 * q + e % 2


def _loads(d):
    """TMA loads of D: its chunks rounded up to whole loads."""
    return -(-(d // BOX) // CHUNKS)


def _f(x):
    return torch.tensor(x, dtype=torch.float32)


def emulate_stats(kept, red, scale, sbo=1024):
    """attn_stats_wgmma: (m, l) over the reduced rows of every kept row,
    each (N*H, S) fp32, one block (64 kept rows, one batch*head) at a time.
    Scores are scaled by scale log2(e) in fp32 and summed as powers of 2;
    m stays in that scale."""
    n_, s, h_, d = kept.shape
    nl = _loads(d)
    stages = attn.wgmma_stages(d)[0]
    kept_at = BASE
    ring_at = kept_at + nl * LOAD
    smem = torch.zeros((ring_at + stages * 2 * LOAD) // 2, dtype=torch.int16)
    frag_row, frag_col = _fragments(64)
    scale2 = _f(scale) * _f(LOG2E)
    m_out = torch.empty((n_ * h_, s))
    l_out = torch.empty((n_ * h_, s))
    rows = (16 * torch.arange(4)[:, None, None]
            + torch.arange(8)[None, :, None]
            + 8 * torch.arange(2)[None, None, :])
    for b in range(n_ * h_):
        n, hd = divmod(b, h_)
        for a0 in range(0, s, ROWS):
            for c in range(nl):
                _put(smem, kept_at + c * LOAD,
                     _tma_load(kept, a0, c * CHUNKS, hd, n, ROWS))
            m = torch.full((2, ROWS), -torch.inf)
            l = torch.zeros((2, ROWS))
            it = 0
            for t in range(-(-s // RED)):
                acc = torch.zeros((2, ROWS, ROWS))
                for c in range(nl):
                    stage = ring_at + (it % stages) * 2 * LOAD
                    _put(smem, stage, _tma_load(red, t * RED, c * CHUNKS, hd,
                                                n, RED))
                    # Every warpgroup multiplies every load (past S too).
                    for wg in range(2):
                        for h in range(CHUNKS):
                            da = _desc(kept_at + (c * CHUNKS + h) * BOX_BYTES,
                                       sbo)
                            db = _desc(stage + h * 2 * BOX_BYTES
                                       + wg * BOX_BYTES, sbo)
                            for kk in range(BOX // 16):
                                acc[wg] += (
                                    _f32(_operand_k(smem, da + 2 * kk, 64))
                                    @ _f32(_operand_k(smem, db + 2 * kk,
                                                      64)).T)
                    it += 1
                for wg in range(2):
                    live = t * RED + wg * ROWS < s
                    # Per thread: its 32 scores, rows g and g + 8 of its
                    # warp's 16; a max and a sum over the quad's 4 lanes.
                    sc = acc[wg][frag_row, frag_col] * scale2    # (128, 32)
                    sc = sc.view(4, 8, 4, 8, 2, 2)   # w, g, t | j, hh, e
                    sc = sc.permute(0, 1, 4, 2, 3, 5).reshape(4, 8, 2, 64)
                    tmax = sc.max(-1).values
                    mn = torch.maximum(m[wg][rows], tmax)
                    sm = torch.exp2(sc - mn[..., None]).sum(-1)
                    if live:
                        l[wg][rows] = (l[wg][rows]
                                       * torch.exp2(m[wg][rows] - mn) + sm)
                        m[wg][rows] = mn
            mm = torch.maximum(m[0], m[1])
            m_out[b, a0:a0 + ROWS] = mm
            l_out[b, a0:a0 + ROWS] = (l[0] * torch.exp2(m[0] - mm)
                                      + l[1] * torch.exp2(m[1] - mm))
    return m_out, l_out


def emulate_apply(q, k, v, scale, axis, m_in, l_in, split=None, sbo=1024,
                  trans_b=1):
    """attn_apply_wgmma<axis == "q">: out (N, S, H, D) bf16 from the final
    stats m_in, l_in (N*H, S), one block (64 queries, one batch*head, one
    column slice) at a time; asserts every output is stored exactly
    once. `split` overrides wgmma_plan's."""
    n_, s, h_, d = q.shape
    nl = _loads(d)
    stages = attn.wgmma_stages(d)[1]
    plan = attn.wgmma_plan(n_ * h_, s, d)
    if split is not None:
        plan = (split, -(-(d // BOX) // split) * BOX)
    split, cols = plan
    slots = -(-cols // (2 * BOX))    # the kernel's NB
    q_at = BASE
    p_at = q_at + nl * LOAD
    ring_at = p_at + 2 * BOX_BYTES
    smem = torch.zeros((ring_at + stages * LOAD) // 2, dtype=torch.int16)
    s_row, s_col = _fragments(32)
    o_row, o_col = _fragments(64)
    out = torch.zeros((n_, s, h_, d))
    stored = torch.zeros((n_, s, h_, d), dtype=torch.int32)
    t_ = torch.arange(128)
    w, g, tg = t_ // 32, (t_ % 32) // 4, t_ % 4
    scale2 = _f(scale) * _f(LOG2E)
    # The stats as the kernel takes them: m (log2 scale) and 1/l.
    m2 = m_in
    rl = 1.0 / l_in
    for b in range(n_ * h_):
        n, hd = divmod(b, h_)
        for i0 in range(0, s, ROWS):
            for z in range(split):
                c0 = z * cols
                nv = min(cols, d - c0) // BOX
                nvl = -(-nv // CHUNKS)
                for c in range(nl):
                    _put(smem, q_at + c * LOAD,
                         _tma_load(q, i0, c * CHUNKS, hd, n, ROWS))
                acc = torch.zeros((2, slots, ROWS, BOX))
                it = 0
                for t in range(s // ROWS):
                    j0 = t * ROWS
                    sc = torch.zeros((2, ROWS, 32))
                    for c in range(nl):
                        stage = ring_at + (it % stages) * LOAD
                        _put(smem, stage, _tma_load(k, j0, c * CHUNKS, hd, n,
                                                    ROWS))
                        for wg in range(2):
                            for h in range(CHUNKS):
                                da = _desc(q_at + (c * CHUNKS + h)
                                           * BOX_BYTES, sbo)
                                db = _desc(stage + h * BOX_BYTES
                                           + wg * BOX_BYTES // 2, sbo)
                                for kk in range(BOX // 16):
                                    sc[wg] += (
                                        _f32(_operand_k(smem, da + 2 * kk,
                                                        64))
                                        @ _f32(_operand_k(smem, db + 2 * kk,
                                                          32)).T)
                        it += 1
                    # P: per thread, its 16 scores; the stats per key (q
                    # axis) or per query row (k axis); 2^(s scale log2(e)
                    # - m) times 1/l, rounded to bf16 and stored as pairs
                    # into the swizzled P tile.
                    pt = p_at + (t % 2) * BOX_BYTES
                    for wg in range(2):
                        frag = sc[wg][s_row, s_col]               # (128, 16)
                        key = j0 + 32 * wg + s_col
                        qrow = i0 + s_row
                        idx = key if axis == "q" else qrow
                        p = (torch.exp2(frag * scale2 - m2[b][idx])
                             * rl[b][idx]).to(torch.bfloat16)
                        bits = p.view(torch.int16)
                        for j in range(4):
                            for hh in range(2):
                                row = 16 * w + g + 8 * hh
                                byte = (pt + row * 128
                                        + (((4 * wg + j) ^ g) << 4) + 4 * tg)
                                smem[byte // 2] = bits[:, 4 * j + 2 * hh]
                                smem[byte // 2 + 1] = bits[:, 4 * j + 2 * hh
                                                           + 1]
                    # P V: slot bi of warpgroup wg reads V chunk
                    # min(2 bi + wg, nv - 1), in load chunk // 2.
                    dp = _desc(pt, sbo)
                    for i in range(nvl):
                        _put(smem, ring_at + ((it + i) % stages) * LOAD,
                             _tma_load(v, j0, c0 // BOX + i * CHUNKS, hd, n,
                                       ROWS))
                    for wg in range(2):
                        for bi in range(slots):
                            vc = min(2 * bi + wg, nv - 1)
                            dv = _desc_mn(ring_at + ((it + vc // CHUNKS)
                                                     % stages) * LOAD
                                          + (vc % CHUNKS) * BOX_BYTES, 1024,
                                          sbo)
                            for kk in range(ROWS // 16):
                                acc[wg, bi] += (
                                    _f32(_operand_k(smem, dp + 2 * kk, 64))
                                    @ _f32(_b_operand(smem, dv + 128 * kk,
                                                      64, trans_b)).T)
                    it += nvl
                # A slot that repeats chunk nv - 1 stores nothing.
                for wg in range(2):
                    for bi in range(slots):
                        if 2 * bi + wg < nv:
                            _epilogue(out, stored,
                                      acc[wg, bi][o_row, o_col], n, hd, i0,
                                      c0 + (2 * bi + wg) * BOX)
    assert (stored == 1).all()
    return out.to(torch.bfloat16)


def _epilogue(out, stored, frag, n, hd, i0, cbox):
    """One box's stores: pairs rounded to bf16, four 8-column blocks
    transposed across the quad (lane t's slot p <- lane p's slot t), 8
    columns a lane."""
    t = torch.arange(128)
    rows = i0 + 16 * (t // 32) + (t % 32) // 4
    tg = t % 4
    for q in range(2):
        j = 4 * q + torch.arange(4)
        for hh in range(2):
            pk0 = frag[:, 4 * j + 2 * hh].to(torch.bfloat16).float()
            pk1 = frag[:, 4 * j + 2 * hh + 1].to(torch.bfloat16).float()
            pk0 = pk0.view(32, 4, 4).transpose(1, 2).reshape(128, 4)
            pk1 = pk1.view(32, 4, 4).transpose(1, 2).reshape(128, 4)
            vals = torch.stack([pk0, pk1], 2).reshape(128, 8)
            row = (rows + 8 * hh)[:, None]
            col = (cbox + 32 * q + 8 * tg)[:, None] + torch.arange(8)[None, :]
            out[n, row, hd, col] = vals
            stored[n, row, hd, col] += 1


def emulate_attention(q, k, v, scale, axis, **kw):
    """Both passes, as sdm_attention_forward launches them: the stats with
    keys kept on the query axis, queries kept on the key axis."""
    stats_kw = {key: val for key, val in kw.items() if key == "sbo"}
    m, l = emulate_stats(*((k, q) if axis == "q" else (q, k)), scale,
                         **stats_kw)
    return emulate_apply(q, k, v, scale, axis, m, l, **kw)


def _exact_qkv(n, s, h, d, seed):
    """numpy-seeded q, k (integers in [-3, 3]) and v (multiples of 1/8 in
    [-1, 1]), as views of one (N, S, H, 3 D) buffer. With scale 128 every
    score is 128 times an integer, so exp(s - m) is 1 at a row's or a
    column's maxima and 0 (underflow) elsewhere: l is an integer count, P
    its reciprocal, and every fp32 sum of the reference and the kernel is
    exact in any order. Which entries are maxima depends on every score."""
    rng = np.random.default_rng(seed)
    buf = np.concatenate([rng.integers(-3, 4, (n, s, h, d)),
                          rng.integers(-3, 4, (n, s, h, d)),
                          rng.integers(-8, 9, (n, s, h, d)) / 8.0], -1)
    qkv = torch.from_numpy(buf).to(torch.bfloat16)
    return qkv.split(d, dim=-1)


EXACT_SCALE = 128.0


def _bits(x):
    return x.contiguous().view(torch.int16)


@pytest.mark.parametrize("axis", ["q", "k"])
@pytest.mark.parametrize("s,d,split", [
    (64, 128, None), (64, 192, None), (128, 128, None), (128, 192, None),
    (64, 128, 1), (128, 192, 1)])
def test_emulated_kernels_reproduce_attention_reference(axis, s, d, split):
    """The emulated stats and apply against `attention_reference`, bit for
    bit, on both axes: S = 64 (one stats box, its second half past S) and
    128, D = 128 and 192 (an odd count of boxes: warpgroup 0 owns two,
    warpgroup 1 one), at wgmma_plan's split and at one block a query tile
    (split 1), two batch rows of one head."""
    q, k, v = _exact_qkv(2, s, 1, d, seed=s + d + (axis == "q"))
    got = emulate_attention(q, k, v, EXACT_SCALE, axis, split=split)
    want = attention_reference(q, k, v, EXACT_SCALE, axis)
    assert got.dtype == want.dtype == torch.bfloat16
    assert torch.equal(_bits(got), _bits(want))
    other = attention_reference(q, k, v, EXACT_SCALE,
                                "k" if axis == "q" else "q")
    assert not torch.equal(_bits(got), _bits(other))


def test_emulated_kernels_on_four_heads():
    """Four heads as strided views of one qkv buffer (the rank-4 maps'
    head axis), the query axis at wgmma_plan's split."""
    q, k, v = _exact_qkv(1, 64, 4, 128, seed=7)
    assert q.stride(2) == 3 * 128
    got = emulate_attention(q, k, v, EXACT_SCALE, "q")
    want = attention_reference(q, k, v, EXACT_SCALE, "q")
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("wrong", ["sbo", "trans_b", "unswizzled"])
def test_emulation_sees_a_wrong_descriptor(wrong, monkeypatch):
    """The check has teeth: a stride byte offset of 512 (four rows, not
    eight), V read K-major (the transpose-B bit clear) or an unswizzled
    read gives other outputs."""
    q, k, v = _exact_qkv(1, 128, 1, 128, seed=3)
    want = attention_reference(q, k, v, EXACT_SCALE, "k")
    kw = {"sbo": dict(sbo=512), "trans_b": dict(trans_b=0)}.get(wrong, {})
    if wrong == "unswizzled":
        monkeypatch.setattr(sys.modules[__name__], "_swizzle", lambda a: a)
    got = emulate_attention(q, k, v, EXACT_SCALE, "k", split=1, **kw)
    assert not torch.equal(_bits(got), _bits(want))


def test_emulation_matches_xla_attention():
    """One small case on normal inputs, both axes, against sdm_tpu's
    `_xla_attention` in bf16: both round P to bf16 after normalising and
    sum in fp32 in other orders (and exp differs in its last bits), so a
    P entry can flip one bf16 ulp: 1e-2 of the element plus 1e-2 of the
    largest output."""
    rng = np.random.default_rng(11)
    qkv = [(std * rng.standard_normal((1, 64, 1, 128))).astype(np.float32)
           for std in (1.5, 1.5, 1.0)]
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in qkv)
    for axis in ("q", "k"):
        got = emulate_attention(tq, tk, tv, 128 ** -0.5, axis).float()
        ref = np.asarray(_xla_attention(
            *(jnp.asarray(a, jnp.bfloat16) for a in qkv), 128 ** -0.5,
            axis).astype(jnp.float32))
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-2,
                                   atol=1e-2 * np.abs(ref).max())


def test_the_emulation_mirrors_the_sources():
    """What the emulation assumes is what the CUDA sources do: the rank-5
    maps' 128B swizzle, loads of two chunks and their strides, both
    descriptors' fields, the transpose-B bit of the P V wgmma and its steps,
    the warpgroups' rows and chunks of each load, the P tile's store
    address and arithmetic, the V chunks of the slots and the constants."""
    with open(os.path.join(_build.CSRC, "wgmma_tiles.cuh")) as f:
        tiles = f.read()
    with open(os.path.join(_build.CSRC, "attention_kernels.cuh")) as f:
        src = f.read()
    chunks = tiles[tiles.index("static int sdm_tma_map_chunks("):]
    chunks = chunks[:chunks.index("\n}\n")]
    for line in ("const cuuint32_t box[5] = {64, (cuuint32_t)box_rows, "
                 "(cuuint32_t)chunks, 1,",
                 "CU_TENSOR_MAP_SWIZZLE_128B",
                 "const cuuint64_t strides[4] = {(cuuint64_t)ss * sizeof(bf16),",
                 "64 * sizeof(bf16),"):
        assert line in chunks, line
    assert ("return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (64ull << 16) "
            "|\n         (64ull << 32) | (1ull << 62);") in tiles
    assert "}, %32, %33, p, 1, 1, 0, 1;" in tiles     # transpose B
    assert "}, %16, %17, p, 1, 1, 0, 0;" in tiles     # m64n32k16, K-major
    for line in (
            "wgmma_m64n64k16(acc, da + 2 * kk, db + 2 * kk, c + h + kk > 0);",
            "wgmma_m64n32k16(s, da + 2 * kk, db + 2 * kk, c + h + kk > 0);",
            "wgmma_m64n64k16_mn(acc[bi], dp + 2 * kk, dv + 128 * kk);",
            "h * 2 * kChunkBytes + wg * kChunkBytes);",
            "h * kChunkBytes + wg * (kChunkBytes / 2));",
            "wgmma_desc(kept + (c * WCHUNKS + h) * kChunkBytes);",
            "wgmma_desc(qs + (c * WCHUNKS + h) * kChunkBytes);",
            "(((4 * wg + j) ^ g) << 4) + 4 * tg) =",
            "const int vc = min(2 * bi + wg, nv - 1), vl = vc / WCHUNKS;",
            "(vc % WCHUNKS) * kChunkBytes);",
            "const bool store = 2 * bi + wg < nv;",
            "return kernels[axis_q != 0][(cols + 2 * WBOX - 1) / (2 * WBOX) - 1];",
            "if (lane == 0 && atomicAdd(&released[x % stages], 1) == 7) {",
            "const uint64_t dp = wgmma_desc(pt);",
            "unsigned char* pt = ps + (t & 1) * kChunkBytes;",
            "exp2f(__fmul_rn(s[4 * j + 2 * hh], scale2) -",
            "rlrow[hh] = __frcp_rn(lb[i0 + 16 * w + g + 8 * hh]);",
            "sum += exp2f(sc[i] - mn);",
            "m_out[(long long)b * S + a0 + r] = mm;",
            "axis_q ? tk : tq, tred,"):
        assert line in src, line
    defines = dict(re.findall(r"#define (\w+) (\d+)", src))
    assert {k: int(defines[k]) for k in (
        "WROWS", "WBOX", "WCHUNKS", "WMAX_D", "WCOLS", "WRED",
        "WSTATS_STAGES", "WAPPLY_STAGES", "WSMS")} == {
        "WROWS": ROWS, "WBOX": BOX, "WCHUNKS": CHUNKS,
        "WMAX_D": attn.WGMMA_MAX_D, "WCOLS": attn.WGMMA_COLS, "WRED": RED,
        "WSTATS_STAGES": attn.WGMMA_STATS_STAGES,
        "WAPPLY_STAGES": attn.WGMMA_APPLY_STAGES, "WSMS": attn.SMS}
