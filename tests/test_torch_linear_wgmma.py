"""The port's bf16 GEMM, `linear_wgmma` (csrc/linear_kernels.cuh), on the CPU.

The kernel runs only on a card. Here: its admission and tile rule (the
Python mirrors in kernels/attention_block.py, which chip_smoke.py holds to
the C exports) at every projection of both U-Nets and off their grid, the
shared memory of each tile, and an emulation of the kernel's data movement
in plain PyTorch: the TMA boxes written into the ring in the 128-byte
swizzled layout (zero past M, N and K), the wgmma operands read back
through the matrix descriptors (wgmma_tiles.cuh's encoding: start >> 4,
stride byte offset 1024, 32 bytes per 16-deep step), and the accumulator
fragments mapped to outputs by both epilogues (the 16-byte one with its
quad transpose, and the pairs). On inputs whose fp32 sums are exact in any
order, the emulation must give `linear_reference` bit for bit.
"""

import math
import os
import re

import numpy as np
import pytest
import torch

from sdm_tpu_torch.kernels import _build
from sdm_tpu_torch.kernels import attention_block as ab

# (S, C) of the attention blocks of the flagship 128x128 and the SR 256x256
# U-Net (chip_smoke.py BLOCK_SHAPES and SR_BLOCK_SHAPES), batch 16: each
# runs `linear` at (M, N, K) = (16 S, 3 C, C) and, with the residual,
# (16 S, C, C). The tile (index into LINEAR_TILES) csrc/linear_kernels.cuh's
# rule gives each: the large one wherever it cuts the output into at least
# 132 tiles.
UNET_TILES = {(1024, 512): (0, 0), (256, 512): (0, 1), (64, 1024): (0, 1),
              (256, 1024): (0, 0), (4096, 512): (0, 0), (1024, 1024): (0, 0)}

# chip_smoke.py's off-grid cases (M, N, K, ldx) and whether the tensor-core
# path takes them: ragged M and N, odd N, a K with an 8-column tail past
# the last 64-deep stage (zero-filled by TMA), and a row stride off 8
# elements (no 16-byte TMA stride).
OFF_GRID = [((300, 200, 512, 512), True), ((300, 197, 512, 512), True),
            ((300, 200, 520, 520), True), ((300, 200, 512, 516), False)]

SMEM_PER_BLOCK = 232448   # what one block may use (227 KB)
SMEM_PER_SM = 233472      # an SM's 228 KB; each block reserves 1 KB of it


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("shape", sorted(UNET_TILES))
def test_linear_wgmma_admits_the_unet_projections(shape):
    """Every bf16 projection of both U-Nets runs on linear_wgmma, and the
    small tile is taken only where the large one would cut the output into
    fewer tiles than the card has SMs."""
    s, c = shape
    tok = _meta((16 * s, c))
    r = _meta((16 * s, c))
    w_qkv, w_out = _meta((3 * c, c)), _meta((c, c))
    assert ab.linear_takes_wgmma(tok, w_qkv)
    assert ab.linear_takes_wgmma(r, w_out, tok)
    tiles = (ab.linear_wgmma_tile(16 * s, 3 * c),
             ab.linear_wgmma_tile(16 * s, c))
    assert tiles == UNET_TILES[shape]
    wg, bn, _ = ab.LINEAR_TILES[0]
    for n, tile in zip((3 * c, c), tiles):
        count = -(-16 * s // (64 * wg)) * -(-n // bn)
        assert (tile == 0) == (count >= ab.LINEAR_SMS)


@pytest.mark.parametrize("case", ["fp32", "k516", "ldx", "x", "w",
                                  "residual"])
def test_linear_wgmma_refuses_other_operands(case):
    """fp32, K off 8 elements (W's rows not a 16-byte TMA stride), a row
    stride of x off 8 elements, and an x, weight or residual pointer off 16
    bytes take the CUDA-core GEMM; ragged M and N do not matter, nor does a
    K off the ring's 64-deep stages."""
    dtype = torch.float32 if case == "fp32" else torch.bfloat16
    k = 516 if case == "k516" else 512
    x = torch.zeros((300, k), dtype=dtype)
    w = torch.zeros((200, k), dtype=dtype)
    res = torch.zeros((300, 200), dtype=dtype)
    assert ab.linear_takes_wgmma(
        x.to(torch.bfloat16), w.to(torch.bfloat16),
        res.to(torch.bfloat16)) == (k % 8 == 0)
    off = lambda *shape: torch.zeros(
        math.prod(shape) + 4, dtype=dtype)[4:].view(*shape)
    if case == "ldx":
        x = torch.zeros((300, 516), dtype=dtype)[:, :512]
    if case == "x":
        x = off(300, 512)
    if case == "w":
        w = off(200, 512)
    if case == "residual":
        res = off(300, 200)
        assert ab.linear_takes_wgmma(x, w)
    assert not ab.linear_takes_wgmma(x, w, res)


def test_linear_wgmma_smem():
    """Each tile's ring (stages of 64 x warpgroups x rows and BN W rows of
    64 bf16), its barriers and the alignment slack fit one block's 227 KB,
    and LINEAR_BLOCKS such blocks share an SM."""
    assert ab.LINEAR_TILES == ((2, 128, 3), (2, 64, 4))
    assert [ab.linear_wgmma_smem_bytes(t) for t in ab.LINEAR_TILES] == [
        1024 + 3 * 256 * 128 + 48, 1024 + 4 * 192 * 128 + 64]
    for tile in ab.LINEAR_TILES:
        smem = ab.linear_wgmma_smem_bytes(tile)
        assert smem <= SMEM_PER_BLOCK
        assert ab.LINEAR_BLOCKS * (smem + 1024) <= SMEM_PER_SM


@pytest.mark.parametrize("case,taken", OFF_GRID)
def test_linear_wgmma_off_grid_admission(case, taken):
    """chip_smoke.py's off-grid shapes: the admission and the tile rule (all
    of them short of 132 large tiles) as the chip check expects them."""
    m, n, k, ldx = case
    x = torch.zeros((m, ldx), dtype=torch.bfloat16)[:, :k]
    w = torch.zeros((n, k), dtype=torch.bfloat16)
    res = torch.zeros((m, n), dtype=torch.bfloat16)
    assert ab.linear_takes_wgmma(x, w, res) == taken
    assert ab.linear_takes_wgmma(x, w) == taken
    assert ab.linear_wgmma_tile(m, n) == 1


# ------------------------------------------------------------ the emulation

RING_BASE = 1024   # the ring's shared address: 1024-byte aligned


def _tma_box(src, r0, c0, box_rows):
    """The image (int16 bit patterns, one per bf16) TMA writes for the box
    of `src` (rows x cols, bf16) at (c0, r0): box_rows x 64 elements,
    zero past src's rows and columns, 128B-swizzled: row r at byte r * 128,
    its 16-byte chunk c at chunk c ^ (r % 8)."""
    rows, cols = src.shape
    bits = src.contiguous().view(torch.int16)
    r = torch.arange(box_rows)[:, None]
    c = torch.arange(64)[None, :]
    gr, gc = r0 + r, c0 + c
    valid = (gr < rows) & (gc < cols)
    vals = torch.where(valid, bits[gr.clamp(max=rows - 1),
                                   gc.clamp(max=cols - 1)],
                       torch.zeros((), dtype=torch.int16))
    byte = r * 128 + (((2 * c) // 16) ^ (r % 8)) * 16 + (2 * c) % 16
    img = torch.zeros(box_rows * 64, dtype=torch.int16)
    img[(byte // 2).reshape(-1)] = vals.reshape(-1)
    return img


def _desc(addr, sbo=1024):
    """wgmma_tiles.cuh's wgmma_desc for a tile at shared address `addr`."""
    return (((addr & 0x3FFFF) >> 4) | (1 << 16) | ((sbo >> 4) << 32)
            | (1 << 62))


def _wgmma_operand(smem, desc, rows):
    """The rows x 16 bf16 (bit patterns) that wgmma reads through a K-major
    128B-swizzle descriptor: element (i, j) at start + (i // 8) * SBO +
    (i % 8) * 128 + 2 j, bits 4-6 of the address XOR bits 7-9."""
    assert desc >> 62 == 1
    start = (desc & 0x3FFF) << 4
    sbo = ((desc >> 32) & 0x3FFF) << 4
    i = torch.arange(rows)[:, None]
    j = torch.arange(16)[None, :]
    addr = start + (i // 8) * sbo + (i % 8) * 128 + 2 * j
    phys = addr ^ (((addr >> 7) & 7) << 4)
    return smem[phys // 2]


def _fragments(bn):
    """(row, col) of accumulator i of warpgroup thread t, each (128, bn / 2):
    warp w = t // 32, lane 4 g + q; d[4 j + e] at row 16 w + g + 8 (e // 2),
    column 8 j + 2 q + e % 2."""
    t = torch.arange(128)[:, None]
    i = torch.arange(bn // 2)[None, :]
    g, q = (t % 32) // 4, t % 4
    j, e = i // 4, i % 4
    return 16 * (t // 32) + g + 8 * (e // 2), 8 * j + 2 * q + e % 2


def _bf16(v):
    return v.to(torch.bfloat16).to(torch.float32)


def emulate_linear_wgmma(x, w, bias, res, tile, sbo=1024):
    """linear_wgmma's data movement, one tile and ring step at a time, with
    the arithmetic in fp32: x (M, K), w (N, K) bf16, bias (N,), res (M, N)
    or None; `tile` an entry of LINEAR_TILES. Returns (M, N) bf16 and
    asserts every output is stored exactly once."""
    m, k = x.shape
    n = w.shape[0]
    wg, bn, stages = tile
    bm = 64 * wg
    x_bytes, w_bytes = bm * 128, bn * 128
    stage_bytes = x_bytes + w_bytes
    smem = torch.zeros((RING_BASE + stages * stage_bytes) // 2,
                       dtype=torch.int16)
    ksteps = -(-k // ab.LINEAR_BK)
    y = torch.zeros((m, n), dtype=torch.float32)
    stored = torch.zeros((m, n), dtype=torch.int32)
    b32 = bias.to(torch.float32)
    r32 = None if res is None else res.to(torch.float32)
    frag_row, frag_col = _fragments(bn)
    it = 0
    for m0 in range(0, m, bm):
        for n0 in range(0, n, bn):
            a_parts = [[] for _ in range(wg)]
            b_parts = []
            for ks in range(ksteps):
                # The producer: both boxes into stage it % stages.
                xs = RING_BASE + (it % stages) * stage_bytes
                smem[xs // 2:(xs + x_bytes) // 2] = _tma_box(
                    x, m0, ks * 64, bm)
                smem[(xs + x_bytes) // 2:(xs + stage_bytes) // 2] = _tma_box(
                    w, n0, ks * 64, bn)
                # The consumers: four 16-deep steps through the descriptors.
                db = _desc(xs + x_bytes, sbo)
                b_parts += [_wgmma_operand(smem, db + 2 * kk, bn)
                            for kk in range(4)]
                for g in range(wg):
                    da = _desc(xs + g * 64 * 128, sbo)
                    a_parts[g] += [_wgmma_operand(smem, da + 2 * kk, 64)
                                   for kk in range(4)]
                it += 1
            b_op = torch.cat(b_parts, 1).view(torch.bfloat16).float()
            assert not b_op[:, k:].any()   # zero-filled past K
            for g in range(wg):
                a_op = torch.cat(a_parts[g], 1).view(torch.bfloat16).float()
                assert not a_op[:, k:].any()
                acc = (a_op @ b_op.T)[frag_row, frag_col]   # (128, bn / 2)
                _epilogue(y, stored, acc, b32, r32, m0 + 64 * g, n0, bn)
    assert (stored == 1).all()
    return y.to(torch.bfloat16)


def _epilogue(y, stored, acc, bias, res, row_base, n0, bn):
    """Both epilogues of linear_wgmma for one warpgroup's accumulators."""
    m, n = y.shape
    t = torch.arange(128)
    rows = row_base + 16 * (t // 32) + (t % 32) // 4     # (128,): row0
    tg = t % 4
    if n % 8 == 0:
        for q in range(bn // 32):
            j = 4 * q + torch.arange(4)[None, :]          # (1, 4) blocks
            col = n0 + 8 * j + 2 * tg[:, None]            # (128, 4)
            inside = col < n
            b0 = torch.where(inside, bias[col.clamp(max=n - 2)], 0.0)
            b1 = torch.where(inside, bias[(col + 1).clamp(max=n - 1)], 0.0)
            for hh in range(2):
                pk0 = _bf16(acc[:, 4 * j[0] + 2 * hh] + b0)
                pk1 = _bf16(acc[:, 4 * j[0] + 2 * hh + 1] + b1)
                # quad_transpose4: lane t's slot p <- lane p's slot t.
                pk0 = pk0.view(32, 4, 4).transpose(1, 2).reshape(128, 4)
                pk1 = pk1.view(32, 4, 4).transpose(1, 2).reshape(128, 4)
                vals = torch.stack([pk0, pk1], 2).reshape(128, 8)
                row = rows + 8 * hh
                col8 = n0 + 32 * q + 8 * tg
                keep = (row < m) & (col8 < n)
                rr = row[keep][:, None]
                cc = col8[keep][:, None] + torch.arange(8)[None, :]
                v = vals[keep]
                if res is not None:
                    v = v + res[rr, cc]
                y[rr, cc] = _bf16(v)
                stored[rr, cc] += 1
        return
    j = torch.arange(bn // 8)[None, :]
    col = n0 + 8 * j + 2 * tg[:, None]                    # (128, bn / 8)
    for hh in range(2):
        row = (rows + 8 * hh)[:, None].expand_as(col)
        for e in range(2):
            c = col + e
            keep = (row < m) & (c < n)
            v = _bf16(acc[:, 4 * j[0] + 2 * hh + e][keep] + bias[c[keep]])
            if res is not None:
                v = v + res[row[keep], c[keep]]
            y[row[keep], c[keep]] = _bf16(v)
            stored[row[keep], c[keep]] += 1


def _exact_operands(m, n, k, ldx, bias_dtype, seed):
    """numpy-seeded x (a view of an (m, ldx) buffer), w, bias and residual
    whose products and sums are exact in fp32 (multiples of 1/128 below
    2^16): any summation order, the kernel's or the reference's, gives the
    same fp32 value, so only the data movement and the epilogue's rounding
    decide the output."""
    rng = np.random.default_rng(seed)
    bf = torch.bfloat16
    x = torch.from_numpy(rng.integers(-8, 9, (m, ldx)) / 8.0).to(bf)[:, :k]
    w = torch.from_numpy(rng.integers(-8, 9, (n, k)) / 16.0).to(bf)
    bias = torch.from_numpy(rng.integers(-256, 257, n) / 128.0).to(bias_dtype)
    res = torch.from_numpy(rng.standard_normal((m, n)) * 4.0).to(bf)
    return x, w, bias, res


EMULATED = [(300, 200, 512, 512), (300, 197, 520, 520),
            (300, 200, 520, 528), (130, 72, 64, 64)]


@pytest.mark.parametrize("tile", [0, 1])
@pytest.mark.parametrize("shape", EMULATED)
@pytest.mark.parametrize("with_res", [False, True])
def test_emulated_kernel_reproduces_linear_reference(shape, tile, with_res):
    """The emulated kernel at each tile against `linear_reference`, bit for
    bit: ragged M and N (the 16-byte epilogue's masks), odd N (the pairs'
    singles), K = 520 (an 8-column tail in the last stage) with ldx = K and
    ldx > K, and a single K step, with and without the residual."""
    m, n, k, ldx = shape
    x, w, bias, res = _exact_operands(
        m, n, k, ldx, torch.bfloat16 if n == 72 else torch.float32,
        seed=sum(shape) + tile)
    r = res if with_res else None
    got = emulate_linear_wgmma(x, w, bias, r, ab.LINEAR_TILES[tile])
    want = ab.linear_reference(x, w, bias, r)
    assert got.dtype == want.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_emulation_sees_a_wrong_descriptor(monkeypatch):
    """The check has teeth: a stride byte offset of 512 (four rows, not
    eight) in the descriptors, or an unswizzled read, gives other outputs."""
    import sys
    x, w, bias, res = _exact_operands(300, 200, 512, 512, torch.float32, 1)
    want = ab.linear_reference(x, w, bias, res)
    got = emulate_linear_wgmma(x, w, bias, res, ab.LINEAR_TILES[0], sbo=512)
    assert not torch.equal(got, want)

    def unswizzled(smem, desc, rows):
        start = (desc & 0x3FFF) << 4
        i = torch.arange(rows)[:, None]
        j = torch.arange(16)[None, :]
        return smem[(start + (i // 8) * 1024 + (i % 8) * 128 + 2 * j) // 2]
    monkeypatch.setattr(sys.modules[__name__], "_wgmma_operand", unswizzled)
    got = emulate_linear_wgmma(x, w, bias, res, ab.LINEAR_TILES[0])
    assert not torch.equal(got, want)


def test_the_emulation_mirrors_the_sources():
    """What the emulation assumes is what the CUDA sources do: the 128B
    swizzle of the TMA maps, the descriptor's fields, one 64-deep stage of
    four 16-deep steps 32 bytes apart, each warpgroup's 64 rows of x, the
    quad transpose and the tile constants."""
    with open(os.path.join(_build.CSRC, "wgmma_tiles.cuh")) as f:
        tiles = f.read()
    with open(os.path.join(_build.CSRC, "linear_kernels.cuh")) as f:
        linear = f.read()
    assert "CU_TENSOR_MAP_SWIZZLE_128B" in tiles
    assert "const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};" in tiles
    assert ("return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) "
            "|\n         (64ull << 32) | (1ull << 62);") in tiles
    assert "wgmma_bf16<BN>(acc, da + 2 * kk, db + 2 * kk);" in linear
    assert "wgmma_desc(xs + wg * 64 * LBK * 2)" in linear
    assert "wgmma_desc(xs + X_BYTES)" in linear
    assert "for (int kk = 0; kk < LBK / 16; ++kk)" in linear
    assert "const int r = p ^ t;" in tiles
    defines = dict(re.findall(r"#define (\w+) (\d+)", linear))
    tiles_c = tuple((int(defines[f"LWG{s}"]), int(defines[f"LBN{s}"]),
                     int(defines[f"LSTAGES{s}"])) for s in ("", "_SMALL"))
    assert tiles_c == ab.LINEAR_TILES
    assert int(defines["LBK"]) == ab.LINEAR_BK == 64
    assert int(defines["LBLOCKS"]) == ab.LINEAR_BLOCKS
    assert int(defines["LSMS"]) == ab.LINEAR_SMS
