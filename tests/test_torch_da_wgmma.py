"""The port's bf16 dK and dQ kernel, `stream_da_wgmma`
(csrc/streaming_attention.cu), on the CPU.

The kernel runs only on a card. Here: its admission, ring stages and
shared memory (the Python mirrors in kernels/streaming_attention.py, which
chip_smoke.py holds to the C exports) at the SR shape and at the shapes it
refuses, and an emulation of its data movement in plain PyTorch, on the
helpers of tests/test_torch_attention_wgmma.py (TMA's swizzled boxes, the
K-major and MN-major descriptors, the accumulator fragments): one block at
a time with its own shared memory; A and A2 resident; a FIFO ring in which
step x lands in stage x % stages only once the 8 warps have released step
x - stages (the last of them loads it), each stage read only while it holds
the step its barrier's parity names (a read of a step not loaded yet is the
deadlock it would be on the card); every step retired and released before
the next one is awaited; the two warpgroups' score
halves (m64n32 K-major products of A B^T and A2 B2^T); dA formed on the
fragments from natural-scale (m, l), rounded to bf16 into the swizzled dA
tile of the tile's parity; dA B with B read MN-major into each warpgroup's
output chunks 2 b + w; and the fp32 epilogue times scale. On inputs whose
fp32 sums are exact in any order the emulation gives
`streaming_dk_reference` and `streaming_dq_reference` bit for bit on both
axes, at the library's tiling and the sweep's; on normal inputs it matches
sdm_tpu's `_backward` in interpret mode within
tests/test_torch_streaming_bwd.py's BF16_OF_MAX, and a log2-scale m or
stats indexed by the wrong rows fail that bound.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdm_tpu.kernels.streaming_attention import _backward, _dv, _forward
from sdm_tpu_torch.kernels import _build
from sdm_tpu_torch.kernels import streaming_attention as sa
from test_torch_attention_wgmma import (_desc, _desc_mn, _f32, _fragments,
                                        _operand_k, _operand_mn, _put,
                                        _tma_box)

ROWS, BOX = sa.DA_ROWS, sa.WGMMA_BOX
CHUNK = ROWS * BOX * 2          # a 64 x 64 bf16 chunk (A, A2, a dA tile)
BASE = 1024                     # the aligned dynamic shared memory
LOG2E = 1.4426950408889634
EXACT_SCALE = 128.0
# tests/test_torch_streaming_bwd.py's bound for the bf16 passes against
# sdm_tpu's: 2e-2 of the element plus 2e-2 of the largest.
BF16_OF_MAX = 2e-2
AXES = {"q": 0, "k": 1}
# (streamed rows a tile, DA_LOAD_CHUNKS): the library's, and the sweep's
# other builds.
TILINGS = {"library": (sa.DA_TILE, sa.DA_LOAD_CHUNKS), "chunks2": (64, 2),
           "tile32": (32, 4)}


@pytest.fixture(autouse=True)
def _one_thread():
    """Thousands of small tensor operations: one thread each, so that the
    suite's parallel workers do not contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _meta(shape, dtype=torch.bfloat16):
    """A tensor with a layout and no storage (the SR shape without 64 MB)."""
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------- the mirrors

def test_da_wgmma_smem_and_stages_at_the_sr_width():
    """stream_da_wgmma's shared memory at D = 512: A and A2 resident (64
    rows x 8 chunks each, 128 KB), two 64 x 64 bf16 dA tiles, the staged
    stats of two tiles (m, 1/l and corr of 64 rows), alignment slack and
    barriers, and the ring's stages of 64 rows x 4 chunks (32 KB): two
    stages, 216,064 bytes, within the opt-in limit. A stage of a whole
    64-row tile of B and B2 (128 KB) does not fit beside A and A2 even
    once."""
    assert (sa.DA_ROWS, sa.DA_TILE, sa.DA_LOAD_CHUNKS, sa.DA_MAX_D) == (
        64, 64, 4, 512)
    assert sa.da_load_chunks(512) == 4 and sa.da_loads(512) == 2
    assert sa.da_wgmma_stages(512) == 2
    assert sa.da_wgmma_smem_bytes(512) == (
        1536 + 2 * 8 * 8192 + 2 * 8192 + 1536 + 2 * 32768) == 216064
    assert sa.da_wgmma_smem_bytes(512) <= sa.MAX_SMEM
    assert 1536 + 2 * 8 * 8192 + 2 * 8 * 8192 > sa.MAX_SMEM


@pytest.mark.parametrize("d,chunks", [(128, 2), (256, 4), (384, 2),
                                      (512, 4)])
def test_da_wgmma_stages_at_each_width(d, chunks):
    """At every D the kernel takes: loads of four chunks where they divide
    D's, else two; as many stages as fit beside A, A2, the dA tiles and
    the staged stats (at most DA_STAGES), never fewer than two (each phase
    holds one step while it waits for the next)."""
    assert sa.da_load_chunks(d) == chunks
    fixed = 1536 + 2 * (d // 64) * 8192 + 2 * 8192 + 1536
    stage = chunks * 8192
    stages = sa.da_wgmma_stages(d)
    assert stages == min((sa.MAX_SMEM - fixed) // stage, sa.DA_STAGES)
    assert stages >= 2
    assert sa.da_wgmma_smem_bytes(d) == fixed + stages * stage <= sa.MAX_SMEM
    assert sa.da_admits_wgmma(torch.bfloat16, 256, d, [0] * 5,
                              [(256 * d, d)] * 5)


@pytest.mark.parametrize("views", [False, True])
def test_da_wgmma_admits_the_sr_shape(views):
    """The SR model's streaming block, (16, 4096, 512) bf16, runs dK and dQ
    on stream_da_wgmma: contiguous, and with q, k and v as strided views of
    one (16, 4096, 3 * 512) qkv buffer, as the attention block passes them;
    g and the fp32 output contiguous."""
    b, s, d = 16, 4096, 512
    if views:
        q, k, v = _meta((b, s, 3 * d)).split(d, dim=-1)
        assert q.stride() == (s * 3 * d, 3 * d, 1)
    else:
        q, k, v = (_meta((b, s, d)) for _ in range(3))
    g, out = _meta((b, s, d)), _meta((b, s, d), torch.float32)
    assert sa.da_takes_wgmma(q, k, v, g, out)
    assert sa.da_admits_wgmma(torch.bfloat16, 1024, 512, [0] * 5,
                              [(1024 * 512, 512)] * 5)


@pytest.mark.parametrize("case", ["fp32", "s300", "d72", "d640", "d1024",
                                  "stride", "pointer"])
def test_da_wgmma_refuses_other_shapes(case):
    """fp32, S = 300 (not a multiple of 64), D off the 128 grid or past
    512, a row stride that is not a multiple of 8 elements and a pointer
    off 16 bytes all take the CUDA-core dA kernel."""
    shape = {"s300": (2, 300, 512), "d72": (2, 256, 72),
             "d640": (2, 256, 640), "d1024": (2, 256, 1024)}.get(
                 case, (2, 256, 512))
    dtype = torch.float32 if case == "fp32" else torch.bfloat16
    q, k, v, g = (torch.zeros(shape, dtype=dtype) for _ in range(4))
    out = torch.zeros(shape, dtype=torch.float32)
    if case == "stride":
        k = torch.zeros((2, 256, 516), dtype=dtype)[:, :, :512]
        assert k.stride(1) % 8 == 4
    if case == "pointer":
        g = torch.zeros(2 * 256 * 512 + 4, dtype=dtype)[4:].view(2, 256, 512)
        assert g.data_ptr() % 16 == 8
    assert not sa.da_takes_wgmma(q, k, v, g, out)
    aligned = [torch.zeros((2, 256, 512), dtype=torch.bfloat16)
               for _ in range(4)]
    assert sa.da_takes_wgmma(*aligned, torch.zeros((2, 256, 512)))


def test_the_mirrors_match_the_source():
    """The constants the mirrors and the emulation assume are the CUDA
    source's, and so are the lines that set what the emulation models: the
    ring's order and release rules, the descriptors' steps, the dA
    formula and its tile, the output chunks, the dispatch; the mma.sync
    kernel is gone from the library."""
    with open(os.path.join(_build.CSRC, "streaming_attention.cu")) as f:
        src = f.read()
    found = dict(re.findall(r"#define (DA_\w+) (\d+)", src))
    assert {k: int(v) for k, v in found.items()} == {
        "DA_TILE": sa.DA_TILE, "DA_LOAD_CHUNKS": sa.DA_LOAD_CHUNKS,
        "DA_ROWS": sa.DA_ROWS, "DA_MAX_D": sa.DA_MAX_D,
        "DA_STAGES": sa.DA_STAGES, "DA_THREADS": 256}
    for line in (
            "if (atomicAdd(&released[st], 1u) != 8u * use - 1) return;",
            "if (x + stages < total) load(x + stages);",
            "for (int x = 0; x < stages && x < total; ++x) load(x);",
            "const bool second = s < 2 * NL && (s & 1);",
            "const int i = s < 2 * NL ? s >> 1 : s - 2 * NL;",
            "da_score<HN>(dp, da + 2 * kk, db + 2 * kk, (i >> 1) + h + kk > 0);",
            "da_score<HN>(s, da + 2 * kk, db + 2 * kk, (i >> 1) + h + kk > 0);",
            "const uint64_t da = wgmma_desc((i & 1 ? a2s : as) +",
            "wg * (kDaChunk / 2));",
            "const float p0 = exp2f((__fmul_rn(s[4 * j + 2 * hh], scale) -",
            "(STAT_COL ? mk.x : mrow[hh])) *",
            "const float x0 = p0 * (dp[4 * j + 2 * hh] -",
            "rlrow[hh] = __frcp_rn(lb[row]);",
            "dt + row * 128 + ((((HN / 8) * wg + j) ^ g) << 4) + 4 * tg) =",
            "unsigned char* dt = dts + (t & 1) * kSwChunk;",
            "const int oc = 2 * bi + wg, x = it + oc / LC, st = x % stages;",
            "wgmma_desc_mn(ring + st * kDaLoad + (oc % LC) * kDaChunk);",
            "wgmma_m64n64k16_mn(acc[bi], dd + 2 * kk, dv + 128 * kk);",
            "const int cbox = (2 * bi + wg) * SW_BOX;",
            "make_float2(acc[bi][4 * j + 2 * hh] * scale,",
            "if (da_wgmma_ok(dt, ptrs, views, S, D))",
            "D > 0 && D % 128 == 0 && D <= DA_MAX_D && da_stages(D) >= 2 &&",
            "release(it);",
            "if (bi == NB - 1 || (2 * bi + 2) / LC != (2 * bi) / LC)",
            "release(it + (2 * bi) / LC);",
            "if (STAT_COL) fetch_stats(t + 1);",
            "if (STAT_COL) stage_stats(t + 1);",
            "dst[DA_TILE] = __frcp_rn(next_l);",
            "return (D / SW_BOX) % DA_LOAD_CHUNKS == 0 ? DA_LOAD_CHUNKS : 2;",
            "constexpr int LC = da_load_chunks(128 * NB);  // chunks a load",
            "rq = *reinterpret_cast<const float2*>(sst + DA_TILE + col);"):
        assert line in src, line
    code = re.sub(r"//[^\n]*", "", src)
    assert not re.search(r"\b(stream_da_mma|launch_da_mma|da_mma_ok)\b",
                         code)
    # dK passes the roles (k, v, q, g) with the stats on the streamed rows
    # on the key axis; dQ (q, g, k, v) on the query axis.
    assert "launch_da<dk_pass>(k, v, q, g, dk, views, batch, S, D, scale,\n" \
           "                            !axis_q," in src
    assert "launch_da<dq_pass>(q, g, k, v, dq, views, batch, S, D, scale, axis_q," in src


# ------------------------------------------------------------ the emulation

class _Ring:
    """A block's FIFO ring: step x is loaded into stage x % stages once the
    8 warps have released step x - stages (by the last of them); a read of
    step x checks that its stage holds it and that the phase's parity is
    the one the kernel waits for (a read of a step not loaded yet is a
    deadlock)."""

    def __init__(self, smem, at, stage_bytes, stages, steps, image):
        self.smem, self.at, self.bytes = smem, at, stage_bytes
        self.stages, self.steps, self.image = stages, steps, image
        self.holds = [None] * stages
        self.phases = [0] * stages
        self.released = [0] * steps
        self.next = 0
        self.produce()

    def produce(self):
        while self.next < self.steps and (
                self.next < self.stages
                or self.released[self.next - self.stages] == 8):
            st = self.next % self.stages
            _put(self.smem, self.at + st * self.bytes, self.image(self.next))
            self.holds[st] = self.next
            self.phases[st] += 1
            self.next += 1

    def stage(self, x):
        st = x % self.stages
        assert self.holds[st] == x, f"step {x} read before it was loaded"
        assert (self.phases[st] - 1) & 1 == (x // self.stages) & 1
        return self.at + st * self.bytes

    def release(self, x, warps=8):
        """`warps` warps release step x (a warpgroup: 4)."""
        self.released[x] += warps
        assert self.released[x] <= 8
        self.produce()


def _load(x4, s0, chunk0, n, rows, lc):
    """One TMA load of the rank-5 map: `lc` chunks of `rows` rows from chunk
    chunk0 on, one swizzled tile after the other (past S or D all zero)."""
    return torch.cat([_tma_box(x4, (chunk0 + i) * BOX, 0, s0, n, rows)
                      for i in range(lc)])


def emulate_da(a, a2, bm, b2, m, l, corr, scale, stat_col, tile=None,
               lc=None, stages=None):
    """stream_da_wgmma<STAT_COL, ., D / 128>: out (B, S, D) fp32 =
    scale sum_b round_bf16(dA_ab) B_b with dA = P (A2 B2^T - corr), P from
    the natural-scale m, l (B, S) indexed by the streamed rows (stat_col)
    or the own rows, one block at a time, at `tile` streamed rows a tile
    and loads of `lc` chunks where they divide D's, else two (DA_TILE and
    DA_LOAD_CHUNKS by default), with `stages` ring stages (the most that
    fit by default). Asserts every output is stored once and every ring
    step loaded once."""
    tile = tile or sa.DA_TILE
    lc = lc or sa.DA_LOAD_CHUNKS
    bsz, s, d = a.shape
    lc = lc if (d // BOX) % lc == 0 else 2     # da_load_chunks
    nb = d // 128
    nl = d // BOX // lc
    hn = tile // 2
    chunk = tile * BOX * 2           # a streamed chunk
    load_bytes = lc * chunk          # a ring stage
    if stages is None:
        fixed = 1536 + 2 * (d // BOX) * CHUNK + 2 * CHUNK + 2 * 3 * tile * 4
        stages = min((sa.MAX_SMEM - fixed) // load_bytes, sa.DA_STAGES)
    a_at = BASE
    a2_at = a_at + (d // BOX) * CHUNK
    dt_at = a2_at + (d // BOX) * CHUNK
    ring_at = dt_at + 2 * CHUNK
    size = ring_at + stages * load_bytes
    a4, a24, b4, b24 = (x[:, :, None] for x in (a, a2, bm, b2))
    s_row, s_col = _fragments(hn)
    o_row, o_col = _fragments(64)
    t_ = torch.arange(128)
    w, g, tg = t_ // 32, (t_ % 32) // 4, t_ % 4
    scale32 = torch.tensor(scale, dtype=torch.float32)
    log2e = torch.tensor(LOG2E, dtype=torch.float32)
    rl = 1.0 / l                     # __frcp_rn: the IEEE reciprocal
    out = torch.zeros((bsz, s, d))
    stored = torch.zeros((bsz, s, d), dtype=torch.int32)
    tiles = s // tile
    for b in range(bsz):

        def image(x):
            t, i = divmod(x, 3 * nl)
            src = b24 if i < 2 * nl and i % 2 else b4
            i = i // 2 if i < 2 * nl else i - 2 * nl
            return _load(src, t * tile, i * lc, b, tile, lc)

        for x0 in range(s // ROWS):
            a0 = x0 * ROWS
            smem = torch.zeros(size // 2, dtype=torch.int16)
            for c in range(nl):
                _put(smem, a_at + c * lc * CHUNK, _load(a4, a0, c * lc, b,
                                                        ROWS, lc))
                _put(smem, a2_at + c * lc * CHUNK, _load(a24, a0, c * lc, b,
                                                         ROWS, lc))
            ring = _Ring(smem, ring_at, load_bytes, stages, tiles * 3 * nl,
                         image)
            acc = torch.zeros((2, nb, ROWS, 64))
            it = 0
            for t in range(tiles):
                j0 = t * tile
                sc = torch.zeros((2, ROWS, hn))
                dp = torch.zeros((2, ROWS, hn))
                # Step 2 i: s += A_i B_i^T, step 2 i + 1: dp += A2_i
                # B2_i^T; each retired and released before the next wait.
                for i in range(2 * nl):
                    st = ring.stage(it)
                    acc_, own = (dp, a2_at) if i % 2 else (sc, a_at)
                    for wg in range(2):
                        for h in range(lc):
                            c = (i // 2) * lc + h
                            off = h * chunk + wg * (chunk // 2)
                            for kk in range(BOX // 16):
                                acc_[wg] += (
                                    _f32(_operand_k(smem, _desc(
                                        own + c * CHUNK) + 2 * kk, 64))
                                    @ _f32(_operand_k(smem, _desc(
                                        st + off) + 2 * kk, hn)).T)
                    ring.release(it)
                    it += 1
                # dA on the fragments into dA tile t % 2.
                dt = dt_at + (t % 2) * CHUNK
                for wg in range(2):
                    fs = sc[wg][s_row, s_col]              # (128, hn / 2)
                    fd = dp[wg][s_row, s_col]
                    idx = (j0 + hn * wg + s_col if stat_col
                           else a0 + s_row)
                    p = (torch.exp2((fs * scale32 - m[b][idx]) * log2e)
                         * rl[b][idx])
                    bits = (p * (fd - corr[b][idx])).to(
                        torch.bfloat16).view(torch.int16)
                    for j in range(hn // 8):
                        for hh in range(2):
                            row = 16 * w + g + 8 * hh
                            byte = (dt + row * 128
                                    + ((((hn // 8) * wg + j) ^ g) << 4)
                                    + 4 * tg)
                            smem[byte // 2] = bits[:, 4 * j + 2 * hh]
                            smem[byte // 2 + 1] = bits[:, 4 * j + 2 * hh + 1]
                # dA B: slot b of both warpgroups in load 2 b / lc, each
                # retired before the next slot's wait, a load released
                # after its last slot.
                for bi in range(nb):
                    for wg in range(2):
                        oc = 2 * bi + wg
                        dv = _desc_mn(ring.stage(it + oc // lc)
                                      + (oc % lc) * chunk)
                        for kk in range(tile // 16):
                            acc[wg, bi] += (
                                _f32(_operand_k(smem, _desc(dt) + 2 * kk, 64))
                                @ _f32(_operand_mn(smem, dv + 128 * kk,
                                                   64)).T)
                    if bi == nb - 1 or (2 * bi + 2) // lc != (2 * bi) // lc:
                        ring.release(it + (2 * bi) // lc)
                it += nl
            assert ring.next == ring.steps
            for wg in range(2):
                for bi in range(nb):
                    cbox = (2 * bi + wg) * BOX
                    out[b, a0 + o_row, cbox + o_col] = (
                        acc[wg, bi][o_row, o_col] * scale32)
                    stored[b, a0 + o_row, cbox + o_col] += 1
    assert (stored == 1).all()
    return out


def emulate_pass(name, q, k, v, g, m, l, corr, scale, axis, **kw):
    """The dK or dQ pass as sdm_streaming_dk / sdm_streaming_dq launch it:
    dQ: A = q, A2 = g, B = k, B2 = v, the stats on the streamed rows on the
    query axis; dK: A = k, A2 = v, B = q, B2 = g, on the key axis. m, l and
    corr (B, 1, S)."""
    ops = (q, g, k, v) if name == "dq" else (k, v, q, g)
    stat_col = (axis == "q") == (name == "dq")
    return emulate_da(*ops, m[:, 0], l[:, 0], corr[:, 0], scale, stat_col,
                      **kw)


def _exact(b, s, d, seed):
    """numpy-seeded q, k (integers in [-3, 3]), v, g (in [-1, 1]) and corr
    (B, 1, S) (integers in [-4, 4]). With scale 128 every score is 128
    times an integer: exp(s - m) is 1 at the maxima and 0 elsewhere, l a
    count, P its reciprocal, dp - corr an integer, and every fp32 sum exact
    in any order."""
    rng = np.random.default_rng(seed)
    q, k = (torch.from_numpy(rng.integers(-3, 4, (b, s, d))).to(
        torch.bfloat16) for _ in range(2))
    v, g = (torch.from_numpy(rng.integers(-1, 2, (b, s, d))).to(
        torch.bfloat16) for _ in range(2))
    corr = torch.from_numpy(rng.integers(-4, 5, (b, 1, s))).float()
    return q, k, v, g, corr


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("name", ["dq", "dk"])
@pytest.mark.parametrize("axis", ["q", "k"])
@pytest.mark.parametrize("s,d,tiling", [
    (64, 128, "library"), (128, 256, "library"), (64, 384, "library"),
    (128, 512, "library"), (128, 512, "chunks2"), (128, 384, "tile32")])
def test_emulated_kernel_reproduces_the_plain_passes(name, axis, s, d,
                                                     tiling):
    """The emulated dK and dQ against `streaming_dk_reference` and
    `streaming_dq_reference`, bit for bit, on both axes (the stats on the
    streamed rows for dQ on the query axis and dK on the key axis, else on
    the own rows), two batch rows: D = 128 (one output chunk a
    warpgroup, loads of two chunks), 256 (one load of four), 384 (three
    slots in three loads of two) and 512 (the SR width: two 32 KB loads a
    phase in two stages, so every step waits for the one before it to be
    released); S = 64 (one tile) and 128 (the ring's phases flipping across
    tiles, both dA tiles used); loads of two chunks at D = 512 (four a
    phase, five stages: the ring wraps inside a tile); 32-row tiles of
    m64n16 scores."""
    q, k, v, g, corr = _exact(2, s, d, seed=s + d + 7 * (axis == "q"))
    m, l = sa.streaming_stats_reference(q, k, EXACT_SCALE, axis)
    tile, lc = TILINGS[tiling]
    got = emulate_pass(name, q, k, v, g, m, l, corr, EXACT_SCALE, axis,
                       tile=tile, lc=lc)
    want = (sa.streaming_dq_reference if name == "dq"
            else sa.streaming_dk_reference)(q, k, v, g, m, l, corr,
                                            EXACT_SCALE, axis)
    assert torch.equal(_bits(got), _bits(want))
    assert want.abs().max() > 0


def test_the_least_ring_wraps_without_deadlock():
    """At D = 512 in loads of two chunks, a ring of two stages (the
    admission's least) gives the same bits as five stages, every step
    loaded once; so does one stage, as no phase holds a stage while it
    waits for the next load; a phase that kept each step until the next
    had landed would deadlock there."""
    q, k, v, g, corr = _exact(1, 128, 512, seed=11)
    m, l = sa.streaming_stats_reference(q, k, EXACT_SCALE, "k")
    want = sa.streaming_dq_reference(q, k, v, g, m, l, corr, EXACT_SCALE,
                                     "k")
    got = emulate_pass("dq", q, k, v, g, m, l, corr, EXACT_SCALE, "k",
                       lc=2, stages=2)
    assert torch.equal(_bits(got), _bits(want))
    got = emulate_pass("dq", q, k, v, g, m, l, corr, EXACT_SCALE, "k",
                       lc=2, stages=1)
    assert torch.equal(_bits(got), _bits(want))
    ring = _Ring(torch.zeros(8192, dtype=torch.int16), 0, 16, 1, 3,
                 lambda x: torch.full((8,), x, dtype=torch.int16))
    ring.stage(0)
    with pytest.raises(AssertionError, match="read before it was loaded"):
        ring.stage(1)


# ------------------------------------------------ against sdm_tpu's kernels

@pytest.fixture
def interpret(monkeypatch):
    from jax.experimental.pallas import tpu as pltpu
    monkeypatch.setenv("SDM_TPU_PALLAS_INTERPRET", "1")
    with pltpu.force_tpu_interpret_mode():
        yield


def _close_bf16(got, want):
    want = np.asarray(want, np.float32)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_OF_MAX,
                               atol=BF16_OF_MAX * float(np.abs(want).max()))


@pytest.mark.parametrize("axis", ["q", "k"])
def test_emulated_kernel_matches_pallas_interpret(interpret, axis):
    """Normal bf16 inputs (1, 256, 128) (S the TPU kernels' tile): the
    emulated dK and dQ against sdm_tpu's `_backward` (Pallas, interpret
    mode) on `_forward`'s (m, l) and the JAX VJP's corr, within the bf16
    bound. Controls that must fail it: m in the log2 scale (what the
    whole-S kernel keeps), and the stats indexed by the wrong rows."""
    rng = np.random.default_rng(31 + AXES[axis])
    arrays = [(std * rng.standard_normal((1, 256, 128))).astype(np.float32)
              for std in (1.5, 1.5, 1.0, 1.0)]
    q, k, v, g = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    jq, jk, jv, jg = (jnp.asarray(a, jnp.bfloat16) for a in arrays)
    scale = 128 ** -0.5
    ax = AXES[axis]
    out32, m_j, l_j = _forward(jq, jk, jv, scale, ax)
    dv_j = _dv(jq, jk, jg, m_j, l_j, scale, ax)
    if axis == "q":
        corr_j = jnp.sum(dv_j * jv.astype(jnp.float32), axis=-1)[:, None, :]
    else:
        corr_j = jnp.sum(jg.astype(jnp.float32) * out32, axis=-1)[:, None, :]
    dq_j, dk_j = _backward(jq, jk, jv, m_j, l_j, corr_j, jg, scale, ax)
    m, l, corr = (torch.from_numpy(np.array(x)) for x in (m_j, l_j, corr_j))
    for name, want in (("dq", dq_j), ("dk", dk_j)):
        got = emulate_pass(name, q, k, v, g, m, l, corr, scale, axis)
        _close_bf16(got, want)
    with pytest.raises(AssertionError):
        _close_bf16(emulate_pass("dq", q, k, v, g, m * LOG2E, l, corr,
                                 scale, axis), dq_j)
    ops = (q, g, k, v)
    wrong_rows = emulate_da(*ops, m[:, 0], l[:, 0], corr[:, 0], scale,
                            stat_col=axis != "q")
    with pytest.raises(AssertionError):
        _close_bf16(wrong_rows, dq_j)
