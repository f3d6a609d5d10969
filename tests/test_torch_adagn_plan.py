"""The one-pass AdaGN kernel's arithmetic and plan (csrc/adagn.cu), on the
CPU.

The CUDA kernel runs only on a card; here a PyTorch emulation of its
partition and merge order (a team of blocks a sample, rows per block,
pieces of rows, each row lane's Chan merges of four rows and Welford tail,
the lanes merged per channel, channels into groups, then the team's
partials merged in eight runs and a fixed tree) is held against sdm_tpu's
XLA AdaGN and its Pallas kernel in interpret mode, in fp32 and bf16, at
narrow shapes planned by the same function as the card's, on small cards
and under the other settings the sweep builds (tools/torch_adagn_tiles.py).
The Python mirror of the C plan (`adagn_plan`) is checked at every shape of
the flagship 128x128 and the SR 256x256 U-Net at batch 1, 2, 8, 16 and 32
in both dtypes; chip_smoke.py holds it to the C function on the card.
"""

import ctypes
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdm_tpu.kernels.adagn import _fused_adagn_impl, _xla_adagn
from sdm_tpu_torch.kernels import _build
from sdm_tpu_torch.kernels import adagn as port_adagn
from sdm_tpu_torch.kernels.adagn import (ONE_PASS, TWO_PASS, Plan,
                                         adagn_plan)

# As tests/test_torch_kernels.py: fp32 against XLA, the same algorithm in
# another summation order; bf16, one rounding of the output that an fp32
# intermediate differing in its last bit can flip.
FP32 = dict(atol=2e-5, rtol=2e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)
# fp32 at an input mean of 50: every Chan and Welford step rounds the
# running mean by up to 2^-24 of 50, and the output carries the mean's
# error times a (about 2e-5 here against XLA's pairwise mean); the
# kernels' own fp32 tolerance on the card (chip_smoke.py TOL).
FP32_MEAN50 = dict(atol=1e-4, rtol=1e-3)
AUNROLL = 4
GROUPS = 32
# (H, W, C) of every AdaGN of the flagship (ADAGN_SHAPES) and the SR model
# (SR_ADAGN_SHAPES) in chip_smoke.py.
MAIN_SHAPES = [(128, 128, 128), (64, 64, 256), (32, 32, 512),
               (16, 16, 512), (8, 8, 1024), (16, 16, 1024), (32, 32, 768),
               (64, 64, 384), (256, 256, 128), (128, 128, 256),
               (64, 64, 512), (32, 32, 1024), (64, 64, 1024),
               (128, 128, 512)]


# ------------------------------------------------------------- emulation

def _chan(acc, nb, mb, m2b):
    """csrc/adagn.cu's chan_merge of (nb, mb, m2b) into acc = [n, mean, M2]
    (n a float; mean and M2 tensors over channels)."""
    if nb == 0:
        return
    na, ma, m2a = acc
    nab = na + nb
    d = mb - ma
    f = torch.tensor(nb, dtype=torch.float32) / torch.tensor(
        nab, dtype=torch.float32)
    acc[1] = ma + d * f
    acc[2] = m2a + (m2b + d * d * torch.tensor(na, dtype=torch.float32) * f)
    acc[0] = nab


def _lane_stats(xb, rl, piece_rows):
    """Each row lane's (count, mean, M2) over a block's rows xb (rows, C):
    row i in lane i % rl; per piece of piece_rows rows, groups of AUNROLL
    of the lane's rows merged by Chan, then Welford's update for the rest
    (stats_rows). All lanes at once, each lane's steps in its order."""
    rows, c = xb.shape
    lanes = torch.arange(rl)
    k = torch.zeros(rl)
    mean = torch.zeros(rl, c)
    m2 = torch.zeros(rl, c)
    for lo in range(0, rows, piece_rows):
        hi = min(rows, lo + piece_rows)
        first = lo + (lanes - lo) % rl
        cnt = torch.clamp((hi - first + rl - 1) // rl, min=0)
        most = int(cnt.max())
        idx = first[:, None] + rl * torch.arange(max(most, 1))[None, :]
        xv = xb[idx.clamp(max=rows - 1)]                 # (rl, most, C)
        full = cnt // AUNROLL
        for q in range(int(full.max())):
            on = (q < full)[:, None]
            chunk = xv[:, AUNROLL * q:AUNROLL * q + AUNROLL]
            mu = chunk[:, 0]
            for u in range(1, AUNROLL):
                mu = mu + chunk[:, u]
            mu = mu * (1.0 / AUNROLL)
            qd = (chunk[:, 0] - mu) * (chunk[:, 0] - mu)
            for u in range(1, AUNROLL):
                qd = qd + (chunk[:, u] - mu) * (chunk[:, u] - mu)
            f = (AUNROLL / (k + AUNROLL))[:, None]
            d = mu - mean
            mean = torch.where(on, mean + d * f, mean)
            m2 = torch.where(on, m2 + (qd + d * d * k[:, None] * f), m2)
            k = k + AUNROLL * on[:, 0]
        for u in range(AUNROLL - 1):
            at = AUNROLL * full + u
            on = at < cnt
            row = xv[lanes, at.clamp(max=max(most - 1, 0))]
            k = k + on
            inv = (1.0 / k.clamp(min=1))[:, None]
            d = row - mean
            new_mean = mean + d * inv
            m2 = torch.where(on[:, None], m2 + d * (row - new_mean), m2)
            mean = torch.where(on[:, None], new_mean, mean)
    return k.tolist(), mean, m2


def _block_partial(xb, groups, piece_rows):
    """A block's (mean, M2) per group over its rows (block_group_stats)."""
    rows, c = xb.shape
    rl = port_adagn.THREADS // (c // 8)
    k, mean, m2 = _lane_stats(xb, rl, piece_rows)
    acc = [0.0, torch.zeros(c), torch.zeros(c)]
    for j in range(rl):
        _chan(acc, float(k[j]), mean[j], m2[j])
    cmean, cm2 = acc[1].reshape(groups, -1), acc[2].reshape(groups, -1)
    cg = c // groups
    mg = cmean[:, 0]
    for j in range(1, cg):
        mg = mg + cmean[:, j]
    mg = mg / cg
    m2g, dev = cm2[:, 0], (cmean[:, 0] - mg) ** 2
    for j in range(1, cg):
        m2g = m2g + cm2[:, j]
        dev = dev + (cmean[:, j] - mg) ** 2
    return mg, m2g + rows * dev


def _shares(hw, blocks):
    return [(i * hw // blocks, (i + 1) * hw // blocks) for i in range(blocks)]


def _merge(parts, counts):
    """A team's partials of one sample: eight contiguous runs of blocks,
    each in block order, then pairwise j with j + 1, j + 2, j + 4."""
    def run(idx):
        acc = [0.0, torch.zeros_like(parts[0][0]),
               torch.zeros_like(parts[0][0])]
        for i in idx:
            _chan(acc, counts[i], *parts[i])
        return acc
    nb = len(parts)
    lanes = [run(range(j * nb // 8, (j + 1) * nb // 8)) for j in range(8)]
    for o in (1, 2, 4):
        for j in range(0, 8, 2 * o):
            _chan(lanes[j], lanes[j + o][0], lanes[j + o][1], lanes[j + o][2])
    return lanes[0]


def emulate(x, gamma, beta, s, t, groups, plan, eps=1e-5,
            out_dtype=torch.float32, equal_counts=False):
    """The one-pass kernel's output for a ONE_PASS `plan`: x (N, H, W, C)
    as fp32 values, gamma/beta (C,), s/t (N or 1, C). equal_counts: the
    fault of weighting every block's partial alike."""
    n, h, w, c = x.shape
    hw = h * w
    xs = x.reshape(n, hw, c).float()
    blocks = plan.blocks // plan.teams     # a team, one sample
    cg = c // groups
    out = torch.empty(n, hw, c, dtype=out_dtype)
    for i in range(n):
        parts, counts = [], []
        for r0, r1 in _shares(hw, blocks):
            parts.append(_block_partial(xs[i, r0:r1], groups,
                                        plan.piece_rows))
            counts.append(float((r1 - r0) * cg))
        if equal_counts:
            counts = [sum(counts) / len(counts)] * len(counts)
        _, mean, m2 = _merge(parts, counts)
        total = torch.tensor(float(hw * cg), dtype=torch.float32)
        inv = 1.0 / torch.sqrt(m2 / total + eps)
        row = i if s.shape[0] > 1 else 0
        sc, sh = s[row].float(), t[row].float()
        g = gamma.float() * sc
        hh = sc * beta.float() + sh
        a = inv.repeat_interleave(cg) * g
        y = (xs[i] - mean.repeat_interleave(cg)) * a + hh
        out[i] = y.to(out_dtype)
    return out.reshape(n, h, w, c)


def _inputs(rng, n, h, w, c, film_rows, mean=0.5, std=2.0):
    x = (rng.standard_normal((n, h, w, c)) * std + mean).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    s = (1.0 + 0.5 * rng.standard_normal((film_rows, c))).astype(np.float32)
    t = (0.5 * rng.standard_normal((film_rows, c))).astype(np.float32)
    return x, gamma, beta, s, t


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _plan(sms, piece_bytes=port_adagn.PIECE_BYTES,
          team_bytes=port_adagn.TEAM_BYTES):
    """adagn_plan's one pass on a card of `sms` SMs, built with
    -DADAGN_PIECE=piece_bytes -DADAGN_TEAM_BYTES=team_bytes (1: one team)
    as the sweep builds csrc/adagn.cu: the module's mirrors of those
    settings patched, the memo bypassed."""
    def plan(n, hw, c, g, monkeypatch):
        with monkeypatch.context() as m:
            m.setattr(port_adagn, "PIECE_BYTES", piece_bytes)
            m.setattr(port_adagn, "TEAM_BYTES", team_bytes)
            return adagn_plan.__wrapped__(n, hw, c, g, torch.bfloat16,
                                          torch.bfloat16, sms=sms)
    return plan


# (name, N, H, W, C, G, plan, FiLM rows, x mean, x std): narrow shapes
# planned by adagn_plan with small pieces and cards, so that every branch
# of the arithmetic runs: lanes with no rows, pieces and block shares of
# ragged lengths, groups of C/G = 3 channels across the 8-channel vectors,
# runs of team_size / 8 blocks of unequal length, teams that walk two
# samples, and a team capped at a block a row (fewer rows than SMs, as 8x8
# at batch 1 or 2 on the H100).
CASES = [
    ("4 blocks a sample, empty lanes", 2, 8, 8, 64, 32,
     _plan(8, 256), 1, 0.5, 2.0),
    ("C/G=3, ragged pieces", 2, 8, 8, 96, 32,
     _plan(4, 576), 2, 0.5, 2.0),
    ("8 blocks a sample, mean 50", 2, 8, 8, 64, 32,
     _plan(16, 512), 1, 50.0, 1.0),
    ("one team of 30, ragged shares", 2, 8, 8, 64, 32,
     _plan(30, 256, team_bytes=1), 2, 0.5, 2.0),
    ("G=16, C/G=3, one team of 26", 2, 8, 8, 48, 16,
     _plan(26, 96, team_bytes=1), 1, 0.5, 2.0),
    ("one team of 8, mean 50", 2, 8, 8, 64, 32,
     _plan(8, 512, team_bytes=1), 2, 50.0, 1.0),
    ("2 teams of 15", 2, 8, 8, 64, 32,
     _plan(30, 256), 1, 0.5, 2.0),
    ("a block a row, 132 SMs over 36 rows", 2, 6, 6, 64, 32,
     _plan(132), 2, 0.5, 2.0),
]


def _case(case, monkeypatch):
    name, n, h, w, c, g, build, rows, mean, std = case
    plan = build(n, h * w, c, g, monkeypatch)
    assert plan.route == ONE_PASS, name
    return n, h, w, c, g, plan, rows, mean, std


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_onepass_emulation_matches_xla(case, dtype, monkeypatch):
    """The one-pass partition and merge order against sdm_tpu's XLA AdaGN;
    in bf16 x and the FiLM tables are bf16 and the output is rounded once
    to bf16 (the kernels' main path)."""
    n, h, w, c, g, plan, rows, mean, std = _case(case, monkeypatch)
    rng = np.random.default_rng(zlib.crc32(case[0].encode()))
    x, gamma, beta, s, t = _inputs(rng, n, h, w, c, rows, mean, std)
    if dtype == "bfloat16":
        x, s, t = _bf16(x), _bf16(s), _bf16(t)
        ref = _xla_adagn(*(jnp.asarray(a, jnp.bfloat16) if i in (0, 3, 4)
                           else jnp.asarray(a)
                           for i, a in enumerate((x, gamma, beta, s, t))),
                         g, 1e-5)
        out_dtype, tol = torch.bfloat16, BF16
    else:
        ref = _xla_adagn(*map(jnp.asarray, (x, gamma, beta, s, t)), g, 1e-5)
        out_dtype, tol = torch.float32, FP32 if mean < 10 else FP32_MEAN50
    got = emulate(*(torch.from_numpy(np.array(a)) for a in
                    (x, gamma, beta, s, t)), g, plan, out_dtype=out_dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), **tol)


@pytest.mark.parametrize("teams", [1, 2])
def test_onepass_emulation_matches_pallas_interpret(teams, monkeypatch):
    """The same against the TPU kernel itself, run in interpret mode as
    tests/test_kernels.py runs it, with per-sample FiLM rows: one team
    over both samples, or one a sample."""
    from jax.experimental.pallas import tpu as pltpu
    monkeypatch.setenv("SDM_TPU_PALLAS_INTERPRET", "1")
    n, h, w, c = 2, 16, 16, 128
    plan = _plan(20, 2048, team_bytes=1 if teams == 1 else 1 << 40)(
        n, h * w, c, GROUPS, monkeypatch)
    assert plan.route == ONE_PASS and plan.teams == teams
    args = _inputs(np.random.default_rng(7 + teams), n, h, w, c, n)
    with pltpu.force_tpu_interpret_mode():
        ref = _fused_adagn_impl(*map(jnp.asarray, args), GROUPS, 1e-5)
    got = emulate(*map(torch.from_numpy, args), GROUPS, plan)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FP32)


def test_emulation_sees_a_wrong_merge(monkeypatch):
    """Control: weighting the blocks' partials alike where their shares
    differ by a row (2 or 3 rows of 30 blocks) moves the output past the
    fp32 tolerance, so the emulation's agreement is not a matter of
    tolerance."""
    n, h, w, c, g, plan, rows, mean, std = _case(CASES[3], monkeypatch)
    args = _inputs(np.random.default_rng(3), n, h, w, c, rows, mean, std)
    ref = np.asarray(_xla_adagn(*map(jnp.asarray, args), g, 1e-5))
    got = emulate(*map(torch.from_numpy, args), g, plan, equal_counts=True)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got.numpy(), ref, **FP32)


# ------------------------------------------------------------ the plan

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("n", [1, 2, 8, 16, 32])
@pytest.mark.parametrize("shape", MAIN_SHAPES,
                         ids=[f"{h}x{w}x{c}" for h, w, c in MAIN_SHAPES])
def test_plan_at_main_path_shapes(shape, n, dtype):
    """The plan of every main-path shape at the served batches (1 and 2:
    small engines, data-parallel shares), the guided 32 and the trainers'
    8 and 16: bf16 one pass (a block an SM of the H100, in teams of equal
    size, one a sample where the samples in flight fit TEAM_BYTES, a row a
    block at least; a ring of whole-row bulk copies of 16-byte multiples
    within the 227 KB a block may have), its scratch; fp32 the two-pass
    kernels."""
    h, w, c = shape
    hw = h * w
    plan = adagn_plan(n, hw, c, GROUPS, dtype, dtype)
    assert isinstance(plan, Plan)
    if dtype == torch.float32:
        assert plan.route == TWO_PASS
        assert plan.chunks == port_adagn.adagn_chunks(n, hw, GROUPS)
        assert port_adagn.scratch_floats(plan, n, GROUPS) == \
            2 * n * plan.chunks * GROUPS
        return
    row = 2 * c
    assert plan.route == ONE_PASS
    team = plan.blocks // plan.teams
    assert plan.teams == min(n, max(1, port_adagn.TEAM_BYTES // (hw * row)))
    assert plan.blocks == plan.teams * team <= port_adagn.SMS
    assert team == min(port_adagn.SMS // plan.teams, hw) and team >= 1
    assert plan.piece_rows * row <= port_adagn.PIECE_BYTES
    assert plan.piece_rows * row % 16 == 0 and row % 16 == 0
    assert plan.smem == port_adagn.onepass_smem(
        port_adagn.SLOTS * plan.piece_rows * row, port_adagn.SLOTS, c,
        GROUPS)
    assert plan.smem + port_adagn.BLOCK_RESERVED <= port_adagn.SM_SMEM
    assert plan.smem <= port_adagn.MAX_SMEM
    assert port_adagn.scratch_floats(plan, n, GROUPS) == \
        2 * n * team * GROUPS


def test_plan_refuses_what_the_kernel_does_not_take():
    """fp32 output, C past MAX_C, C % 8 != 0 or G past 32 keep the two
    passes; a sample with fewer rows than a team would have blocks takes
    the one pass with a block a row."""
    bf = torch.bfloat16
    assert adagn_plan(16, 64, 64, 32, bf, torch.float32).route == TWO_PASS
    assert adagn_plan(16, 64, 2048, 32, bf, bf).route == TWO_PASS
    assert adagn_plan(16, 64, 72, 36, bf, bf).route == TWO_PASS
    assert adagn_plan(16, 64, 512, 64, bf, bf).route == TWO_PASS
    assert adagn_plan(16, 100, 64, 32, bf, bf).route == ONE_PASS
    # one team (a sample of 8x8x1024) of 64 blocks, not 132
    plan = adagn_plan(1, 64, 1024, 32, bf, bf)
    assert (plan.route, plan.teams, plan.blocks) == (ONE_PASS, 1, 64)


# ------------------------------------------------------------ the wrapper

def test_wrapper_makes_one_call_and_counts_routes(monkeypatch):
    """One ctypes call a launch; the one pass counts in
    `one_pass_launches`, the two passes in `two_pass_launches`; the one
    pass takes the kept partials and counters (zeroed once) and allocates
    nothing but its output."""
    calls = []

    class Lib:
        def sdm_adagn_forward(self, *args):
            calls.append(args)
            return 0

    fn = port_adagn.fused_adagn
    for name in ("launches", "one_pass_launches", "two_pass_launches"):
        monkeypatch.setattr(fn, name, 0)
    monkeypatch.setattr(_build, "require_cuda", lambda *a: None)
    monkeypatch.setattr(_build, "library", lambda *a, **k: Lib())
    monkeypatch.setattr(_build, "stream_handle", lambda d: 7)
    monkeypatch.setattr(port_adagn, "sm_count", lambda d: 132)
    monkeypatch.setattr(port_adagn, "_GRID_BUFFERS", {})

    class Dev:
        def __init__(self, *a):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False
    monkeypatch.setattr(torch.cuda, "device", Dev)

    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, device="meta", dtype=dtype)

    for h, c, dtype in ((8, 1024, torch.bfloat16), (128, 128, torch.bfloat16),
                        (128, 128, torch.bfloat16), (8, 64, torch.float32)):
        x = meta(16, h, h, c, dtype=dtype)
        port_adagn._forward(x, meta(c, dtype=dtype), meta(c, dtype=dtype),
                            meta(1, c, dtype=dtype), meta(1, c, dtype=dtype),
                            32, 1e-5)
    assert len(calls) == 4
    assert (fn.launches, fn.one_pass_launches, fn.two_pass_launches) == \
        (4, 3, 1)
    plans = [adagn_plan(16, h * h, c, 32, torch.bfloat16, torch.bfloat16)
             for h, c in ((8, 1024), (128, 128))]
    assert all(p.route == ONE_PASS for p in plans)
    assert calls[0][7] == port_adagn.scratch_floats(plans[0], 16, 32)
    # The kept buffers: the partials grow to the larger plan, the counters
    # (2 N) stay; calls 2 and 3 take the same ones.
    assert calls[1][7] == calls[2][7] == port_adagn.scratch_floats(
        plans[1], 16, 32) >= calls[0][7]
    assert calls[0][9] == calls[1][9] == calls[2][9] == 2 * 16
    assert len(port_adagn._GRID_BUFFERS) == 1
    assert calls[3][7] == 2 * 16 * port_adagn.adagn_chunks(16, 64, 32) * 32
    assert calls[3][8] is None and calls[3][9] == 0
    assert all(isinstance(a, (int, float, type(None))) for a in calls[0])
    sig = port_adagn._SIGNATURES["sdm_adagn_forward"][1]
    assert len(calls[0]) == len(sig)
    assert sig[7] is ctypes.c_longlong
