"""The port's bf16 streaming attention forward, `stream_stats_wgmma` and
`stream_apply_wgmma` (csrc/streaming_attention.cu), and its dV pass (the
apply kernel with q and k swapped, `stream_apply_wgmma<..., dv_pass>`), on
the CPU.

The kernels run only on a card. Here: their admission, launch plan
(column slices, kept rows, load size) and shared memory (the Python
mirrors in kernels/streaming_attention.py, which chip_smoke.py holds to
the C exports) at the SR shape and off it, and an emulation of both
kernels' data movement in plain PyTorch, on the helpers of
tests/test_torch_attention_wgmma.py (TMA's swizzled boxes, the
descriptors' addressing, the fragments and the bf16 epilogue): one block
at a time with its own shared memory, every ring step loaded into stage
x % stages (the stats: by the producer; the apply: by the warp whose
release completes the stage's u-th use, the 8 warps in a seeded order),
each stage read only while it holds the step its barrier's parity names,
the (m, l) in the natural scale, P normalised and then rounded to bf16,
and the bf16 or fp32 epilogue. On inputs whose fp32 sums
are exact in any order, the emulation gives `streaming_stats_reference`
and `streaming_apply_reference` bit for bit on both axes. On normal
inputs its (m, l) drive the plain backward passes to sdm_tpu's within
tests/test_torch_streaming_bwd.py's bound (a log2-scale m fails it), and
its forward matches sdm_tpu's `_forward` in interpret mode. The emulated
apply with dV's roles (k, q, g, the other axis, fp32 out) gives
`streaming_dv_reference` bit for bit on both axes and sdm_tpu's `_dv`
within the bf16 bound; with the axis or the roles left unswapped it does
not.
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
from test_torch_attention_wgmma import (_desc, _desc_mn, _epilogue, _f32,
                                        _fragments, _operand_k, _operand_mn,
                                        _put, _tma_box, _tma_load)

ROWS, BOX, CHUNKS, RED = (sa.WGMMA_ROWS, sa.WGMMA_BOX, sa.WGMMA_CHUNKS,
                          sa.WGMMA_RED)
BOX_BYTES = ROWS * BOX * 2      # a 64 x 64 chunk
LOAD = CHUNKS * BOX_BYTES       # a 64-row stats load (two chunks)
BASE = 1024                     # the aligned dynamic shared memory
LOG2E = 1.4426950408889634
EXACT_SCALE = 128.0
# tests/test_torch_streaming_bwd.py's bounds: bf16 passes against sdm_tpu's
# (2e-2 of the element plus 2e-2 of the largest), fp32 (m, l) against the
# Pallas stats.
BF16_OF_MAX = 2e-2
FP32 = dict(rtol=2e-4, atol=2e-5)
AXES = {"q": 0, "k": 1}


@pytest.fixture(autouse=True)
def _one_thread():
    """The emulation runs thousands of small tensor operations: with a
    thread pool in each of the suite's parallel workers they contend for
    the cores (a case ran 300 times slower there than alone), so each test
    here runs on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _f(x):
    return torch.tensor(x, dtype=torch.float32)


# ---------------------------------------------------------- the mirrors

@pytest.mark.parametrize("views", [False, True])
@pytest.mark.parametrize("shape", [(4096, 512), (1024, 512), (256, 1024),
                                   (64, 128), (3264, 128)])
def test_wgmma_admits_the_streaming_shapes(shape, views):
    """The SR model's (4096, 512) block and every bf16 shape at S % 64 ==
    0, D % 64 == 0, D <= 1024 run on the wgmma forward: contiguous, and as
    the attention block passes q, k, v (views of one qkv buffer), into a
    bf16 or an fp32 output. fp32 inputs do not."""
    s, d = shape
    if views:
        q, k, v = _meta((16, s, 3 * d)).split(d, dim=-1)
    else:
        q, k, v = (_meta((16, s, d)) for _ in range(3))
    out = _meta((16, s, d))
    assert sa.stats_takes_wgmma(q, k)
    assert sa.apply_takes_wgmma(q, k, v, out)
    assert sa.apply_takes_wgmma(q, k, v, out.float())
    assert not sa.stats_takes_wgmma(q.float(), k.float())
    assert not sa.apply_takes_wgmma(q.float(), k.float(), v.float(),
                                    out.float())


@pytest.mark.parametrize("case", ["fp32", "s100", "d72", "d32", "d1088",
                                  "stride", "pointer", "out_pointer"])
def test_wgmma_refuses_off_grid(case):
    """fp32, S % 64 != 0, D % 64 != 0, D under 64 or past 1024, a row
    stride that is not a multiple of 8 elements and a pointer off 16 bytes
    (of an input or of the output) are refused; those shapes take the
    CUDA-core kernels."""
    shape = {"s100": (2, 100, 512), "d72": (2, 256, 72), "d32": (2, 256, 32),
             "d1088": (2, 256, 1088)}.get(case, (2, 256, 512))
    dtype = torch.float32 if case == "fp32" else torch.bfloat16
    q, k, v, out = (torch.zeros(shape, dtype=dtype) for _ in range(4))
    if case == "stride":
        k = torch.zeros((2, 256, 516), dtype=dtype)[..., :512]
    if case in ("pointer", "out_pointer"):
        bad = torch.zeros(2 * 256 * 512 + 4, dtype=dtype)[4:].view(2, 256, 512)
        assert bad.data_ptr() % 16 == 8
        if case == "pointer":
            v = bad
        else:
            out = bad
    if case != "out_pointer":
        assert not sa.apply_takes_wgmma(q, k, v, out)
    else:
        assert sa.stats_takes_wgmma(q, k)
        assert not sa.apply_takes_wgmma(q, k, v, out)
    if case in ("fp32", "s100", "d72", "d32", "d1088", "stride"):
        assert not sa.stats_takes_wgmma(q, k)


def _dv_meta(s, d, views):
    """q, k, g and dv of the dV pass at (16, S, D) as the attention block's
    backward hands them to `streaming_dv`: bf16 q and k contiguous or views
    of one (16, S, 3 D) qkv buffer, g contiguous, dv a new fp32 tensor."""
    if views:
        q, k, _ = _meta((16, s, 3 * d)).split(d, dim=-1)
    else:
        q, k = _meta((16, s, d)), _meta((16, s, d))
    return q, k, _meta((16, s, d)), _meta((16, s, d), torch.float32)


@pytest.mark.parametrize("views", [False, True])
@pytest.mark.parametrize("shape", [(4096, 512), (1024, 512), (256, 640),
                                   (256, 1024)])
def test_dv_takes_the_wgmma_apply(shape, views):
    """dV runs on stream_apply_wgmma<..., dv_pass> with the roles swapped
    (`apply_takes_wgmma(k, q, g, dv)`): at the SR model's (4096, 512) block
    and at (1024, 512), contiguous and as views of the qkv buffer, into an
    fp32 dv; also at D = 640 and 1024, which the mma.sync dV refused (D %
    128 or past 512). fp32 inputs do not."""
    q, k, g, dv = _dv_meta(*shape, views)
    assert sa.apply_takes_wgmma(k, q, g, dv)
    assert not sa.apply_takes_wgmma(k.float(), q.float(), g.float(), dv)


@pytest.mark.parametrize("case", ["fp32", "s300", "d72", "d32", "d1088",
                                  "stride", "g_pointer", "dv_pointer"])
def test_dv_refuses_off_grid(case):
    """dV on its layout (k, q, g, fp32 dv): fp32 inputs, S % 64 != 0, D %
    64 != 0, D under 64 or past 1024, a row stride that is not a multiple
    of 8 elements and a pointer off 16 bytes (of g or of dv) are refused;
    those take the CUDA-core kernel."""
    shape = {"s300": (2, 300, 512), "d72": (2, 256, 72), "d32": (2, 256, 32),
             "d1088": (2, 256, 1088)}.get(case, (2, 256, 512))
    dtype = torch.float32 if case == "fp32" else torch.bfloat16
    q, k, g = (torch.zeros(shape, dtype=dtype) for _ in range(3))
    dv = torch.zeros(shape, dtype=torch.float32)
    if case == "stride":
        k = torch.zeros((2, 256, 516), dtype=dtype)[..., :512]
        assert k.stride(1) % 8 == 4
    if case.endswith("pointer"):
        t = dtype if case == "g_pointer" else torch.float32
        n = 16 // torch.empty((), dtype=t).element_size() // 2
        bad = torch.zeros(2 * 256 * 512 + n, dtype=t)[n:].view(2, 256, 512)
        assert bad.data_ptr() % 16 == 8
        if case == "g_pointer":
            g = bad
        else:
            dv = bad
    assert not sa.apply_takes_wgmma(k, q, g, dv)
    aligned = [torch.zeros((2, 256, 512), dtype=torch.bfloat16)
               for _ in range(3)]
    assert sa.apply_takes_wgmma(*aligned, torch.zeros((2, 256, 512)))


@pytest.mark.parametrize("d", [64, 128, 320, 512, 576, 704, 1024])
def test_wgmma_smem_and_stages(d):
    """Both kernels' shared memory: the stats' kept tile (128 rows where
    two 32 KB ring stages fit beside it, D <= 640; else 64 rows and the two
    warpgroups' (m, l)) and ring of 128-row loads of two chunks; the
    apply's Q tile, ring of 64-row loads of eight chunks (64 KB, at 256 <
    D <= 512) or four (32 KB) and two P tiles; alignment slack and
    barriers; all within 232,448 bytes, with at least two stats stages and
    two apply stages holding the V loads of a 512-column slice."""
    stats, apply = sa.wgmma_smem_bytes(d)
    s_st, a_st = sa.wgmma_stages(d)
    kept = sa.wgmma_stats_kept(d)
    assert kept == (128 if d <= 640 else 64)
    assert stats == (1536 + (1024 if kept == 64 else 0)
                     + -(-d // 128) * 2 * 8192 * (kept // 64) + s_st * 32768)
    ac = 8 if 256 < d <= 512 else 4
    assert sa.wgmma_apply_chunks(d) == ac
    assert apply == (1536 + (-(-d // (64 * ac)) * ac + 2) * 8192
                     + a_st * ac * 8192)
    assert max(stats, apply) <= sa.MAX_SMEM
    assert s_st >= 2 and a_st >= max(2, 8 // ac)
    if d == 512:
        assert (stats, apply, s_st, a_st) == (230912, 214528, 3, 2)


@pytest.mark.parametrize("d,plan", [
    (512, (1, 512, 128, 8)), (64, (1, 64, 128, 4)), (128, (1, 128, 128, 4)),
    (256, (1, 256, 128, 4)), (576, (2, 320, 128, 4)),
    (1024, (2, 512, 64, 4))])
def test_wgmma_plan(d, plan):
    """One column slice up to D = 512, else ceil(D / 512) slices of whole
    chunks covering D; 128 kept rows a stats block where two stats stages
    fit beside them (D <= 640), else 64; apply loads of eight chunks at
    256 < D <= 512, else four."""
    split, cols, kept, ac = sa.wgmma_plan(d)
    assert (split, cols, kept, ac) == plan
    assert cols % 64 == 0 and cols <= 512
    assert (split - 1) * cols < d <= split * cols
    assert kept == sa.wgmma_stats_kept(d) and ac == sa.wgmma_apply_chunks(d)


def test_the_mirrors_match_the_sources():
    """The constants the mirrors and the emulation assume are the CUDA
    source's, and so are the lines that set what the emulation models:
    the natural-scale (m, l), the ring's issue and release rules, the
    descriptors' steps, the dispatch order of the entry points and dV's
    roles on the apply kernel."""
    with open(os.path.join(_build.CSRC, "streaming_attention.cu")) as f:
        src = f.read()
    defines = dict(re.findall(r"#define (SW_\w+) (\d+)", src))
    assert {k: int(v) for k, v in defines.items()} == {
        "SW_ROWS": ROWS, "SW_BOX": BOX, "SW_CHUNKS": CHUNKS,
        "SW_APPLY_CHUNKS": sa.WGMMA_APPLY_CHUNKS,
        "SW_APPLY_CHUNKS_S": sa.WGMMA_APPLY_CHUNKS_S,
        "SW_MAX_D": sa.WGMMA_MAX_D, "SW_COLS": sa.WGMMA_COLS,
        "SW_RED": RED, "SW_STATS_STAGES": sa.WGMMA_STATS_STAGES,
        "SW_APPLY_STAGES": sa.WGMMA_APPLY_STAGES, "SW_STATS_THREADS": 288,
        "SW_APPLY_THREADS": 256, "SW_STATS_KEPT": sa.WGMMA_STATS_KEPT}
    for line in (
            "const float x = __fmul_rn(acc[4 * j + 2 * hh + e], scale);",
            "sc[2 * j + e] = !WIDE || 8 * j + 2 * tg + e < lim ? x : -INFINITY;",
            "for (int i = 0; i < N / 4; ++i) sum += exp2f((sc[i] - mn) * kSwLog2e);",
            "l[hh] = live ? l[hh] * exp2f((m[hh] - mn) * kSwLog2e) + sum : l[hh];",
            "l_out[(long long)b * S + a0 + r] = l0 * exp2f((m0 - mm) * kSwLog2e) +",
            "if (row < S) {",
            "m_out[(long long)b * S + a0 + r] = mm;",
            "mbar_init(&empty[i], 8);",
            "if (it >= stages) mbar_wait(&empty[st], ((it / stages) & 1) ^ 1);",
            "if (atomicAdd(&released[st], 1u) != 8u * use - 1) return;",
            "if (x + stages >= total) return;",
            "load(x + stages);",
            "wgmma_m64n64k16(acc, da + 2 * kk, db + 2 * kk, c + h + kk > 0);",
            "wgmma_desc(kept + (c * SW_CHUNKS + h) * kKeptChunk +",
            "(WIDE ? wg * kSwChunk : 0));",
            "wgmma_desc(ring + st * 2 * kSwLoad + h * 2 * kSwChunk +",
            "(WIDE ? 0 : wg * kSwChunk));",
            "wgmma_m64n128k16(acc, da + 2 * kk, db + 2 * kk, c + h + kk > 0);",
            "wgmma_m64n32k16(s, da + 2 * kk, db + 2 * kk, c + h + kk > 0);",
            "wg * (kSwChunk / 2));",
            "wgmma_m64n64k16_mn(acc[bi], dp + 2 * kk, dv + 128 * kk);",
            "const int vc = min(2 * bi + wg, nv - 1), vl = vc / AC;",
            "(vc % AC) * kSwChunk);",
            "const uint64_t da = wgmma_desc(qs + (c * AC + h) * kSwChunk);",
            "const uint64_t db = wgmma_desc(ring + st * kSwApplyLoad + h * kSwChunk +",
            "constexpr int kSwApplyLoad = AC * kSwChunk;",
            "return D > 4 * SW_BOX && D <= SW_COLS ? SW_APPLY_CHUNKS : SW_APPLY_CHUNKS_S;",
            "const int vl = min(2 * bi + wg, nv - 1) / AC;",
            "if (bi == NB - 1 || min(2 * bi + 2 + wg, nv - 1) / AC != vl)",
            "(((4 * wg + j) ^ g) << 4) + 4 * tg) =",
            "const float p0 = exp2f((__fmul_rn(s[4 * j + 2 * hh], scale) -",
            "rlrow[hh] = __frcp_rn(lb[i0 + 16 * w + g + 8 * hh]);",
            "const bool store = 2 * bi + wg < nv;",
            "if (sw_ok(dt, ptrs, views, 2, S, D))",
            "if (sw_ok(dt, ptrs, views, 4, S, D))",
            "return launch_apply_wgmma<Pass>(",
            "template <bool QAXIS, typename OutT, int NB, int AC, typename Pass>",
            "&stream_apply_wgmma<false, OutT, 4, W_, Pass>},",
            "const auto kernel = sw_apply_kernel<OutT, Pass>(axis_q, cols, ac);",
            # dV: the apply's (q, k, v, out) are (k, q, g, dv), the axis
            # flipped (emulate_dv).
            "views[0] = in[1];\n  views[1] = in[0];\n  views[2] = in[2];\n"
            "  views[3] = in[3];\n  return launch_apply<dv_pass>(k, q, g, dv, "
            "views, batch, S, D, scale,\n                               "
            "!axis_q, m, l, dt,"):
        assert line in src, line
    # The forward and dV take the wgmma kernels where sw_ok admits them,
    # else the CUDA-core ones: one dispatch for both passes, no mma.sync.
    stats = src[src.index("SDM_EXPORT int sdm_streaming_stats("):]
    stats = stats[:stats.index("\n}\n")]
    assert "sw_ok(" in stats and "mma_ok" not in stats
    apply = src[src.index("static int launch_apply("):]
    apply = apply[:apply.index("\n}\n")]
    assert (apply.index("sw_ok(") < apply.index("launch_apply_wgmma<Pass>(")
            < apply.index("&stream_apply<float"))
    assert "mma" not in apply.replace("wgmma", "") and "constexpr" not in apply
    dv = src[src.index("SDM_EXPORT int sdm_streaming_dv("):]
    dv = dv[:dv.index("\n}\n")]
    assert "launch_apply<dv_pass>(" in dv and "float* dv" in dv


# ------------------------------------------------------------ the emulation

def _loads(d, per=CHUNKS):
    return -(-(d // BOX) // per)


def _apply_load(x, s0, chunk0, n, ac):
    """One apply load of the rank-5 map: `ac` chunks of 64 rows from chunk
    chunk0 on, one swizzled tile after the other (past D all zeros)."""
    return torch.cat([_tma_box(x, (chunk0 + i) * BOX, 0, s0, n, ROWS)
                      for i in range(ac)])


class _Ring:
    """A block's ring: step x lands in stage x % stages, completing that
    stage's barrier phase x // stages; a read of step x checks that the
    stage holds it and that its phase's parity is the one the kernel waits
    for."""

    def __init__(self, size, ring_at, stage_bytes, stages):
        self.smem = torch.zeros(size // 2, dtype=torch.int16)
        self.ring_at, self.bytes, self.stages = ring_at, stage_bytes, stages
        self.holds = [None] * stages
        self.phases = [0] * stages
        self.issued = []   # (issuing warp, step)

    def load(self, x, img, warp=None):
        st = x % self.stages
        _put(self.smem, self.ring_at + st * self.bytes, img)
        self.holds[st] = x
        self.phases[st] += 1
        self.issued.append((warp, x))

    def stage(self, x):
        st = x % self.stages
        assert self.holds[st] == x
        assert (self.phases[st] - 1) & 1 == (x // self.stages) & 1
        return self.ring_at + st * self.bytes


def emulate_stats(kept, red, scale, rows_a_block=None):
    """stream_stats_wgmma<rows_a_block> (sw_stats_kept's rows by default):
    (m, l) of every kept row (natural scale), each (B, S) fp32, one block
    at a time. 128 kept rows: warpgroup w multiplies its own 64 against all
    128 reduced rows of a load (m64n128k16) and drops the columns past S;
    64: both warpgroups the block's 64, each against 64 reduced rows,
    merged at the end."""
    b_, s, d = kept.shape
    kept4, red4 = kept[:, :, None], red[:, :, None]
    nl = _loads(d)
    kr = rows_a_block or sa.wgmma_stats_kept(d)
    wide = kr == 2 * ROWS
    n = RED if wide else ROWS          # reduced rows a warpgroup
    stages = sa._stats_stages(d, kr)
    chunk_bytes = kr * BOX * 2         # a kept chunk tile
    kept_at = BASE
    ring_at = kept_at + nl * CHUNKS * chunk_bytes
    size = ring_at + stages * 2 * LOAD
    frag_row, frag_col = _fragments(n)
    scale32, log2e = _f(scale), _f(LOG2E)
    m_out = torch.empty((b_, s))
    l_out = torch.empty((b_, s))
    rows = (16 * torch.arange(4)[:, None, None]
            + torch.arange(8)[None, :, None]
            + 8 * torch.arange(2)[None, None, :])
    # A thread's scores of one row, in its fragment's order (quad lane t,
    # 8-column block j, element e): column 8 j + 2 t + e.
    cols = (2 * torch.arange(4)[:, None, None]
            + 8 * torch.arange(n // 8)[None, :, None]
            + torch.arange(2)[None, None, :]).reshape(-1)
    for b in range(b_):
        for x in range(-(-s // kr)):
            ring = _Ring(size, ring_at, 2 * LOAD, stages)
            for c in range(nl):
                _put(ring.smem, kept_at + c * CHUNKS * chunk_bytes,
                     _tma_load(kept4, x * kr, c * CHUNKS, 0, b, kr))
            m = torch.full((2, ROWS), -torch.inf)
            l = torch.zeros((2, ROWS))
            it = 0
            for t in range(-(-s // RED)):
                acc = torch.zeros((2, ROWS, n))
                for c in range(nl):
                    ring.load(it, _tma_load(red4, t * RED, c * CHUNKS, 0, b,
                                            RED))
                    stage = ring.stage(it)
                    for wg in range(2):
                        for h in range(CHUNKS):
                            da = _desc(kept_at + (c * CHUNKS + h) * chunk_bytes
                                       + (wg * BOX_BYTES if wide else 0))
                            db = _desc(stage + h * 2 * BOX_BYTES
                                       + (0 if wide else wg * BOX_BYTES))
                            for kk in range(BOX // 16):
                                acc[wg] += (
                                    _f32(_operand_k(ring.smem, da + 2 * kk,
                                                    64))
                                    @ _f32(_operand_k(ring.smem, db + 2 * kk,
                                                      n)).T)
                    it += 1
                for wg in range(2):
                    live = wide or t * RED + wg * ROWS < s
                    # Per thread its scaled scores, rows g and g + 8 of its
                    # warp's 16; max and sum over the quad.
                    sc = acc[wg][frag_row, frag_col] * scale32
                    sc = sc.view(4, 8, 4, n // 8, 2, 2).permute(
                        0, 1, 4, 2, 3, 5).reshape(4, 8, 2, n)
                    if wide:
                        sc = torch.where(cols < s - t * RED, sc, -torch.inf)
                    mn = torch.maximum(m[wg][rows], sc.max(-1).values)
                    sm = torch.exp2((sc - mn[..., None]) * log2e).sum(-1)
                    if live:
                        l[wg][rows] = (l[wg][rows]
                                       * torch.exp2((m[wg][rows] - mn)
                                                    * log2e) + sm)
                        m[wg][rows] = mn
            a0 = x * kr
            if wide:
                # Each warpgroup's own rows; none past S.
                span = min(kr, s - a0)
                m_out[b, a0:a0 + span] = m.reshape(-1)[:span]
                l_out[b, a0:a0 + span] = l.reshape(-1)[:span]
                continue
            mm = torch.maximum(m[0], m[1])
            m_out[b, a0:a0 + ROWS] = mm
            l_out[b, a0:a0 + ROWS] = (
                l[0] * torch.exp2((m[0] - mm) * log2e)
                + l[1] * torch.exp2((m[1] - mm) * log2e))
    return m_out, l_out


def emulate_apply(q, k, v, scale, axis, m_in, l_in, out_dtype=torch.bfloat16,
                  seed=0, trans_b=1):
    """stream_apply_wgmma<axis == "q", out_dtype>: out (B, S, D) from the
    natural-scale stats m_in, l_in (B, S), one block at a time. The 8 warps
    release each step in an order drawn from `seed`, and the warp whose
    release completes the stage's count loads the step `stages` on.
    Asserts every output is stored once and every step loaded once.
    Returns (out, the (warp, step) of every load after the first
    `stages`)."""
    b_, s, d = q.shape
    q4, k4, v4 = (x[:, :, None] for x in (q, k, v))
    split, cols, _, AC = sa.wgmma_plan(d)
    ALOAD = AC * BOX_BYTES          # an apply load
    nl = _loads(d, AC)
    stages = sa.wgmma_stages(d)[1]
    slots = -(-cols // (2 * BOX))
    q_at = BASE
    p_at = q_at + nl * ALOAD
    ring_at = p_at + 2 * BOX_BYTES
    size = ring_at + stages * ALOAD
    s_row, s_col = _fragments(32)
    o_row, o_col = _fragments(64)
    out = torch.zeros((b_, s, 1, d))
    stored = torch.zeros((b_, s, 1, d), dtype=torch.int32)
    t_ = torch.arange(128)
    w, g, tg = t_ // 32, (t_ % 32) // 4, t_ % 4
    scale32, log2e = _f(scale), _f(LOG2E)
    rl = 1.0 / l_in    # __frcp_rn: the IEEE reciprocal
    rng = np.random.default_rng(seed)
    refills = []
    for b in range(b_):
        for z in range(split):
            c0 = z * cols
            nv = min(cols, d - c0) // BOX
            nvl = -(-nv // AC)
            steps = nl + nvl
            total = (s // ROWS) * steps
            for x0 in range(s // ROWS):
                ring = _Ring(size, ring_at, ALOAD, stages)
                counters = [0] * stages

                def load(x, warp=None):
                    t, i = divmod(x, steps)
                    if i < nl:
                        img = _apply_load(k4, t * ROWS, i * AC, b, AC)
                    else:
                        img = _apply_load(v4, t * ROWS,
                                          c0 // BOX + (i - nl) * AC, b, AC)
                    ring.load(x, img, warp)

                def release(x):
                    st, use = x % stages, x // stages + 1
                    done = 0
                    for n, warp in enumerate(rng.permutation(8)):
                        counters[st] += 1
                        if counters[st] != 8 * use:
                            continue
                        # Only the last release refills.
                        assert n == 7
                        done += 1
                        if x + stages < total:
                            load(x + stages, int(warp))
                    assert done == 1

                i0 = x0 * ROWS
                for c in range(nl):
                    _put(ring.smem, q_at + c * ALOAD,
                         _apply_load(q4, i0, c * AC, b, AC))
                for x in range(min(stages, total)):
                    load(x)
                acc = torch.zeros((2, slots, ROWS, BOX))
                it = 0
                for t in range(s // ROWS):
                    j0 = t * ROWS
                    sc = torch.zeros((2, ROWS, 32))
                    for c in range(nl):
                        stage = ring.stage(it)
                        for wg in range(2):
                            for h in range(AC):
                                da = _desc(q_at + (c * AC + h) * BOX_BYTES)
                                db = _desc(stage + h * BOX_BYTES
                                           + wg * BOX_BYTES // 2)
                                for kk in range(BOX // 16):
                                    sc[wg] += (
                                        _f32(_operand_k(ring.smem,
                                                        da + 2 * kk, 64))
                                        @ _f32(_operand_k(ring.smem,
                                                          db + 2 * kk,
                                                          32)).T)
                        release(it)
                        it += 1
                    pt = p_at + (t % 2) * BOX_BYTES
                    for wg in range(2):
                        frag = sc[wg][s_row, s_col]            # (128, 16)
                        idx = (j0 + 32 * wg + s_col if axis == "q"
                               else i0 + s_row)
                        p = (torch.exp2((frag * scale32 - m_in[b][idx])
                                        * log2e)
                             * rl[b][idx]).to(torch.bfloat16)
                        bits = p.view(torch.int16)
                        for j in range(4):
                            for hh in range(2):
                                row = 16 * w + g + 8 * hh
                                byte = (pt + row * 128
                                        + (((4 * wg + j) ^ g) << 4) + 4 * tg)
                                ring.smem[byte // 2] = bits[:, 4 * j + 2 * hh]
                                ring.smem[byte // 2 + 1] = bits[
                                    :, 4 * j + 2 * hh + 1]
                    dp = _desc(pt)
                    for wg in range(2):
                        for bi in range(slots):
                            vc = min(2 * bi + wg, nv - 1)
                            dv = _desc_mn(ring.stage(it + vc // AC)
                                          + (vc % AC) * BOX_BYTES)
                            b_op = (_operand_mn if trans_b
                                    else lambda sm, dsc, n: _operand_k(
                                        sm, dsc, n))
                            for kk in range(ROWS // 16):
                                acc[wg, bi] += (
                                    _f32(_operand_k(ring.smem, dp + 2 * kk,
                                                    64))
                                    @ _f32(b_op(ring.smem, dv + 128 * kk,
                                                64)).T)
                    for vl in range(nvl):
                        release(it + vl)
                    it += nvl
                # The epilogue; a slot that repeats chunk nv - 1 stores
                # nothing.
                for wg in range(2):
                    for bi in range(slots):
                        if 2 * bi + wg >= nv:
                            continue
                        cbox = c0 + (2 * bi + wg) * BOX
                        frag = acc[wg, bi][o_row, o_col]
                        if out_dtype == torch.float32:
                            out[b, i0 + o_row, 0, cbox + o_col] = frag
                            stored[b, i0 + o_row, 0, cbox + o_col] += 1
                        else:
                            _epilogue(out, stored, frag, b, 0, i0, cbox)
                assert sorted(x for _, x in ring.issued) == list(range(total))
                refills += [(wp, x) for wp, x in ring.issued if wp is not None]
    assert (stored == 1).all()
    return out[:, :, 0].to(out_dtype), refills


def emulate_dv(q, k, g, scale, axis, m, l, swap_axis=True, swap_roles=True):
    """The dV pass as sdm_streaming_dv launches it: the apply kernel on (k,
    q, g) into an fp32 dv, on the other softmax axis, from the forward's
    (m, l) (B, S) on `axis`: its own rows are keys, its streamed rows
    queries, its values g. `swap_axis`, `swap_roles` False: the controls."""
    apply_axis = ("k" if axis == "q" else "q") if swap_axis else axis
    a, b = (k, q) if swap_roles else (q, k)
    return emulate_apply(a, b, g, scale, apply_axis, m, l, torch.float32)[0]


def emulate_forward(q, k, v, scale, axis, out_dtype=torch.bfloat16, **kw):
    """Both passes as the entry points launch them: the stats with keys kept
    on the query axis, queries kept on the key axis, then the apply."""
    m, l = emulate_stats(*((k, q) if axis == "q" else (q, k)), scale)
    return emulate_apply(q, k, v, scale, axis, m, l, out_dtype, **kw)[0]


def _exact_qkv(b, s, d, seed):
    """numpy-seeded q, k (integers in [-3, 3]) and v (multiples of 1/8 in
    [-1, 1]) as (B, S, D) views of one (B, S, 3 D) buffer, as the attention
    block passes them. With scale 128 every score is 128 times an integer:
    exp(s - m) is 1 at the maxima and 0 elsewhere, l a count, P its
    reciprocal, and every fp32 sum exact in any order."""
    rng = np.random.default_rng(seed)
    buf = np.concatenate([rng.integers(-3, 4, (b, s, d)),
                          rng.integers(-3, 4, (b, s, d)),
                          rng.integers(-8, 9, (b, s, d)) / 8.0], -1)
    return torch.from_numpy(buf).to(torch.bfloat16).split(d, dim=-1)


def _bits(x):
    return x.contiguous().view(torch.int16 if x.dtype == torch.bfloat16
                               else torch.int32)


@pytest.mark.parametrize("axis", ["q", "k"])
@pytest.mark.parametrize("s,d", [(64, 128), (128, 128), (128, 192),
                                 (256, 128), (128, 320), (64, 512),
                                 (64, 576), (64, 768)])
def test_emulated_kernels_reproduce_the_plain_passes(axis, s, d):
    """The emulated stats against `streaming_stats_reference` and the
    emulated apply (from those stats) against `streaming_apply_reference`,
    bit for bit, bf16 and fp32 output: S = 64 (one block, the stats
    block's second 64 kept rows and its load's second 64 reduced rows past
    S), 128 and 256 (two and four apply blocks, each stats ring reused), D
    = 192 (three chunks, the last load's fourth past D), 320 (eight-chunk
    apply loads, three of them past D; three slots a warpgroup) and 512
    (the SR width: one K and one V load a key tile), 576 (two column slices
    of 320 and 256 columns in four-chunk loads; 128 kept rows), 768 (64
    kept rows, the warpgroups' (m, l) merged); two batch rows."""
    q, k, v = _exact_qkv(2, s, d, seed=s + d + (axis == "q"))
    kept, red = (k, q) if axis == "q" else (q, k)
    m, l = emulate_stats(kept, red, EXACT_SCALE)
    m_ref, l_ref = sa.streaming_stats_reference(q, k, EXACT_SCALE, axis)
    assert torch.equal(m, m_ref[:, 0]) and torch.equal(l, l_ref[:, 0])
    for out_dtype in (torch.bfloat16, torch.float32):
        got, _ = emulate_apply(q, k, v, EXACT_SCALE, axis, m, l, out_dtype)
        want = sa.streaming_apply_reference(q, k, v, m_ref, l_ref,
                                            EXACT_SCALE, axis, out_dtype)
        assert got.dtype == want.dtype == out_dtype
        assert torch.equal(_bits(got), _bits(want))
    other = sa.streaming_attention_reference(q, k, v, EXACT_SCALE,
                                             "k" if axis == "q" else "q")
    assert not torch.equal(_bits(got.to(torch.bfloat16)), _bits(other))


@pytest.mark.parametrize("axis", ["q", "k"])
@pytest.mark.parametrize("s,d", [(64, 128), (128, 128), (128, 192),
                                 (256, 128), (64, 512), (64, 576)])
def test_emulated_apply_reproduces_the_plain_dv(axis, s, d):
    """dV on the emulated apply kernel (`emulate_dv`: k, q, g, the other
    axis, fp32 out), from `emulate_stats`'s (m, l), against
    `streaming_dv_reference` on the same stats, bit for bit: one and two
    64-row blocks of keys, D = 192 (the last load's fourth chunk past D),
    512 (the SR width: one eight-chunk load of queries and one of g a
    tile) and 576 (two column slices); two batch rows. On the query axis
    (the SR model's) dV is the apply's key-axis form, its stats per own
    row."""
    q, k, g = _exact_qkv(2, s, d, seed=s + d + 2 * (axis == "q"))
    m, l = emulate_stats(*((k, q) if axis == "q" else (q, k)), EXACT_SCALE)
    got = emulate_dv(q, k, g, EXACT_SCALE, axis, m, l)
    want = sa.streaming_dv_reference(q, k, g, m[:, None], l[:, None],
                                     EXACT_SCALE, axis)
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("control", ["axis", "roles"])
def test_emulated_dv_controls_fail(control):
    """The check has teeth: the apply kernel on dV's tensors with the
    softmax axis left as the forward's, or with q and k left in the
    forward's roles, gives another dV on both axes."""
    q, k, g = _exact_qkv(1, 128, 128, seed=7)
    for axis in ("q", "k"):
        m, l = emulate_stats(*((k, q) if axis == "q" else (q, k)),
                             EXACT_SCALE)
        want = sa.streaming_dv_reference(q, k, g, m[:, None], l[:, None],
                                         EXACT_SCALE, axis)
        assert torch.equal(_bits(emulate_dv(q, k, g, EXACT_SCALE, axis, m,
                                            l)), _bits(want))
        got = emulate_dv(q, k, g, EXACT_SCALE, axis, m, l,
                         swap_axis=control != "axis",
                         swap_roles=control != "roles")
        assert not torch.equal(_bits(got), _bits(want))


def test_emulation_sees_the_transpose_bit():
    """The check has teeth: V read K-major (the transpose-B bit clear)
    gives other outputs."""
    q, k, v = _exact_qkv(1, 128, 128, seed=3)
    m, l = (t[:, 0] for t in sa.streaming_stats_reference(q, k, EXACT_SCALE,
                                                          "k"))
    want = sa.streaming_apply_reference(q, k, v, m[:, None], l[:, None],
                                        EXACT_SCALE, "k")
    got, _ = emulate_apply(q, k, v, EXACT_SCALE, "k", m, l)
    assert torch.equal(_bits(got), _bits(want))
    got, _ = emulate_apply(q, k, v, EXACT_SCALE, "k", m, l, trans_b=0)
    assert not torch.equal(_bits(got), _bits(want))


def test_release_order_does_not_matter():
    """Whichever warp releases a stage last issues its next load: three
    seeded release orders, the same bits, every step loaded once, and more
    than one warp issuing."""
    q, k, v = _exact_qkv(1, 256, 128, seed=5)
    m, l = (t[:, 0] for t in sa.streaming_stats_reference(q, k, EXACT_SCALE,
                                                          "q"))
    outs, issuers = [], set()
    for seed in range(3):
        got, refills = emulate_apply(q, k, v, EXACT_SCALE, "q", m, l,
                                     seed=seed)
        outs.append(_bits(got))
        issuers |= {warp for warp, _ in refills}
    assert all(torch.equal(o, outs[0]) for o in outs)
    assert len(issuers) > 1


# ------------------------------------------------ against sdm_tpu's kernels

@pytest.fixture
def interpret(monkeypatch):
    from jax.experimental.pallas import tpu as pltpu
    monkeypatch.setenv("SDM_TPU_PALLAS_INTERPRET", "1")
    with pltpu.force_tpu_interpret_mode():
        yield


def _normal(shape, seed):
    """bf16 q, k (std 1.5), v, g (std 1), numpy-seeded, as torch tensors
    and JAX arrays."""
    rng = np.random.default_rng(seed)
    arrays = [(std * rng.standard_normal(shape)).astype(np.float32)
              for std in (1.5, 1.5, 1.0, 1.0)]
    tensors = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
    return tensors, [jnp.asarray(a, jnp.bfloat16) for a in arrays]


def _close_bf16(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_OF_MAX,
                               atol=BF16_OF_MAX * float(np.abs(want).max()))


@pytest.mark.parametrize("axis", ["q", "k"])
def test_emulated_forward_matches_pallas_interpret(interpret, axis):
    """The emulated (m, l) and output against sdm_tpu's `_forward` (its
    stats and apply Pallas kernels in interpret mode) on normal bf16
    inputs, (2, 256, 128): (m, l) within the fp32 bound of the plain
    passes, the output within the bf16 one (both round P to bf16 after
    fp32 sums in other orders)."""
    (q, k, v, _), (jq, jk, jv, _) = _normal((2, 256, 128), seed=21)
    scale = 128 ** -0.5
    out_j, m_j, l_j = _forward(jq, jk, jv, scale, AXES[axis])
    m, l = emulate_stats(*((k, q) if axis == "q" else (q, k)), scale)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_j)[:, 0], **FP32)
    np.testing.assert_allclose(l.numpy(), np.asarray(l_j)[:, 0], **FP32)
    got, _ = emulate_apply(q, k, v, scale, axis, m, l)
    _close_bf16(got, jnp.asarray(out_j).astype(jnp.bfloat16))


@pytest.mark.parametrize("axis", ["q", "k"])
def test_emulated_stats_drive_the_backward(interpret, axis):
    """The emulated kernels' (m, l) fed to the plain dV, dK and dQ passes
    against sdm_tpu's `_dv` and `_backward` on `_forward`'s own (m, l),
    within tests/test_torch_streaming_bwd.py's bf16 bound; the same stats
    with m in the log2 scale (what the whole-S kernel keeps) fail it, as
    the backward reads exp(s scale - m) / l."""
    (q, k, v, g), (jq, jk, jv, jg) = _normal((1, 256, 128), seed=22)
    scale = 128 ** -0.5
    ax = AXES[axis]
    out32_j, m_j, l_j = _forward(jq, jk, jv, scale, ax)
    dv_j = _dv(jq, jk, jg, m_j, l_j, scale, ax)
    if axis == "q":
        corr_j = jnp.sum(dv_j * jv.astype(jnp.float32), axis=-1)[:, None, :]
    else:
        corr_j = jnp.sum(jg.astype(jnp.float32) * out32_j,
                         axis=-1)[:, None, :]
    dq_j, dk_j = _backward(jq, jk, jv, m_j, l_j, corr_j, jg, scale, ax)
    corr = torch.from_numpy(np.array(corr_j))
    m, l = emulate_stats(*((k, q) if axis == "q" else (q, k)), scale)
    m, l = m[:, None], l[:, None]

    def passes(m_, l_):
        return (sa.streaming_dv_reference(q, k, g, m_, l_, scale, axis),
                sa.streaming_dk_reference(q, k, v, g, m_, l_, corr, scale,
                                          axis),
                sa.streaming_dq_reference(q, k, v, g, m_, l_, corr, scale,
                                          axis))

    for got, want in zip(passes(m, l), (dv_j, dk_j, dq_j)):
        _close_bf16(got, want)
    with pytest.raises(AssertionError):
        _close_bf16(passes(m * LOG2E, l)[0], dv_j)


@pytest.mark.parametrize("axis", ["q", "k"])
def test_emulated_dv_matches_pallas_interpret(interpret, axis):
    """dV on the emulated kernels (`emulate_stats`, then `emulate_dv`)
    against sdm_tpu's `_dv` on `_forward`'s own (m, l), both Pallas kernels
    in interpret mode, on normal bf16 inputs, (1, 256, 128): within
    tests/test_torch_streaming_bwd.py's bf16 bound (2e-2 of the element
    plus 2e-2 of the largest; both round P to bf16 after fp32 sums in other
    orders)."""
    (q, k, _, g), (jq, jk, jv, jg) = _normal((1, 256, 128), seed=23)
    scale = 128 ** -0.5
    ax = AXES[axis]
    _, m_j, l_j = _forward(jq, jk, jv, scale, ax)
    dv_j = _dv(jq, jk, jg, m_j, l_j, scale, ax)
    m, l = emulate_stats(*((k, q) if axis == "q" else (q, k)), scale)
    _close_bf16(emulate_dv(q, k, g, scale, axis, m, l), dv_j)
