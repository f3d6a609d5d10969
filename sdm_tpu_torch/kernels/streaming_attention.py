"""Streaming (two-pass) attention over (B, S, D), forward and backward,
softmax over the query axis ("q", the reference's parity quirk) or the key
axis ("k").

Port of sdm_tpu/kernels/streaming_attention.py::streaming_attention and its
custom VJP (`_vjp_fwd`/`_vjp_bwd`, :328-355). Forward: the stats pass
(`_stats_kernel` :97-112, launched at :223) and the apply pass
(`_apply_kernel` :120-130, launched at :234). Backward: the dV pass
(`_dv_kernel` :133, launched at :298), the dK pass (`_dk_kernel` :152, :260)
and the dQ pass (`_dq_kernel` :167, :271). The CUDA kernels are
csrc/streaming_attention.cu: the stats pass merges online (m, l) over the
reduced tiles, the apply pass walks key tiles with the final stats, dV is
the apply kernel with the roles of q and k swapped, and dK and dQ share
one kernel that recomputes P and dA tile by tile. None holds more than one
score tile, so shared memory does not depend on S. The bf16 forward at
S % 64 == 0, D % 64 == 0, D <= 1024 with 16-byte aligned rows runs on
TMA + wgmma: the stats pass on `stream_stats_wgmma` (128 kept rows a block
where they fit), the apply pass on `stream_apply_wgmma` (loads of eight
chunks at 256 < D <= 512) (`stats_takes_wgmma`, `apply_takes_wgmma`,
`admits_wgmma`, mirrors of the C admission; `wgmma_plan`, `wgmma_stages`
and `wgmma_smem_bytes` mirror the launch plan and the shared memory), and
so does dV at the same shapes, on `stream_apply_wgmma<..., dv_pass>`
(`apply_takes_wgmma(k, q, g, dv)`). So do dK and dQ in bf16 at S % 64 ==
0, D % 128 == 0, D <= 512 with aligned rows, on `stream_da_wgmma`
(`da_takes_wgmma`, `da_admits_wgmma`; `da_wgmma_stages` and
`da_wgmma_smem_bytes` mirror its ring and shared memory). fp32, and bf16
at other shapes, take CUDA-core kernels. Each tensor-core launch, all of
them TMA + wgmma, counts in the wrapper's `mma_launches` and in its
`wgmma_launches`.
The whole-S kernel (kernels/attention.py) takes bf16 grids up to S = 3200
and fp32 up to S = 1687; the dispatchers send longer ones,
such as the 256x256 SR model's S = 4096, here. Every pass is bound by
operations (per batch row 2*S*S*D for the stats, 4*S*S*D for the apply pass
and dV, 6*S*S*D for dK and for dQ).

  streaming_stats(q, k, scale, axis) -> (m, l), each (B, 1, S) fp32: the
      running max and denominator over the reduced axis (per key for "q",
      per query for "k"), merged tile by tile.
  streaming_apply(q, k, v, m, l, scale, axis, out_dtype) -> out (B, S, D):
      sum_j round_v(exp(s_ij - m) / l) v_j, fp32 accumulation, one rounding
      to out_dtype (q's dtype by default; the TPU kernel writes fp32 and
      `streaming_attention` casts; the key-axis backward keeps the fp32).
  streaming_dv(q, k, g, m, l, scale, axis) -> dV = P^T g, fp32 (B, S, D).
  streaming_dk / streaming_dq(q, k, v, g, m, l, corr, scale, axis) ->
      dK = scale dA^T q, dQ = scale dA k, fp32, with dA = P (g v^T - corr).
  streaming_attention(q, k, v, scale, axis): the forward as a
      torch.autograd.Function whose backward runs the three backward passes.

Each has a plain PyTorch version (`*_reference`) that runs tile by tile, as
the TPU kernels do, so it never holds an S x S score matrix either, and
rounds where they round: P to g's dtype before P^T g, g to the input dtype,
dA to the input dtype before dA^T q and dA k. The wrappers take it only for
CPU tensors; on CUDA tensors they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from sdm_tpu_torch.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "sdm_streaming_stats": (_I, [_P, _P, _P, _P, _P, _I, _I, _I,
                                 ctypes.c_float, _I, _I, _P]),
    "sdm_streaming_apply": (_I, [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                 ctypes.c_float, _I, _I, _I, _P]),
    "sdm_streaming_dv": (_I, [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                              ctypes.c_float, _I, _I, _P]),
    "sdm_streaming_dk": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                              ctypes.c_float, _I, _I, _P]),
    "sdm_streaming_dq": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                              ctypes.c_float, _I, _I, _P]),
    "sdm_streaming_da_takes_wgmma": (_I, [_P, _P, _I, _I, _I]),
    "sdm_streaming_da_wgmma_smem": (_I, [_I, _P]),
    "sdm_streaming_stats_takes_wgmma": (_I, [_P, _P, _I, _I, _I]),
    "sdm_streaming_apply_takes_wgmma": (_I, [_P, _P, _I, _I, _I]),
    "sdm_streaming_wgmma_smem": (_I, [_I, _P]),
    "sdm_streaming_wgmma_plan": (_I, [_I, _P]),
}

# Opt-in shared memory per block on sm_90 (csrc/attention_tiles.cuh MAX_SMEM).
MAX_SMEM = 232448
# stream_da_wgmma (csrc/streaming_attention.cu DA_ROWS, DA_TILE,
# DA_LOAD_CHUNKS, DA_MAX_D, DA_STAGES): own rows a block, streamed rows a
# tile, 64-column chunks a TMA load (where they divide D's, else two),
# widest D, most ring stages.
DA_ROWS, DA_TILE, DA_LOAD_CHUNKS, DA_MAX_D, DA_STAGES = 64, 64, 4, 512, 16
# The wgmma forward (csrc/streaming_attention.cu SW_ROWS, SW_BOX,
# SW_CHUNKS, SW_APPLY_CHUNKS, SW_APPLY_CHUNKS_S, SW_MAX_D, SW_COLS, SW_RED,
# SW_STATS_STAGES, SW_APPLY_STAGES, SW_STATS_KEPT): queries an apply
# block, columns a chunk, chunks a stats TMA load and an apply one (at
# 256 < D <= 512, else the second), widest D, widest output slice of an
# apply block, reduced rows a stats load, most ring stages of each kernel,
# and kept rows a stats block (where they fit).
WGMMA_ROWS, WGMMA_BOX, WGMMA_CHUNKS = 64, 64, 2
WGMMA_APPLY_CHUNKS, WGMMA_APPLY_CHUNKS_S = 8, 4
WGMMA_MAX_D, WGMMA_COLS, WGMMA_RED = 1024, 512, 128
WGMMA_STATS_STAGES, WGMMA_APPLY_STAGES = 8, 16
WGMMA_STATS_KEPT = 128
# Alignment slack and the barriers' room (kSwFixed), a 64 x 64 bf16 chunk.
_WGMMA_FIXED, _WGMMA_CHUNK = 1024 + 512, 64 * 64 * 2


def _wgmma_chunks(d: int, per: int = WGMMA_CHUNKS) -> int:
    """Chunks of D rounded up to whole loads of `per` chunks (sw_chunks)."""
    return -(-(d // WGMMA_BOX) // per) * per


def _stats_fixed(d: int, kept: int) -> int:
    """sw_stats_fixed: the stats' shared memory besides the ring, the kept
    tile of `kept` rows and, at 64 kept rows, the warpgroups' (m, l)."""
    return (_WGMMA_FIXED + (2 * 2 * WGMMA_ROWS * 4 if kept == WGMMA_ROWS
                            else 0)
            + _wgmma_chunks(d) * _WGMMA_CHUNK * (kept // WGMMA_ROWS))


def _stats_stages(d: int, kept: int) -> int:
    load = WGMMA_CHUNKS * _WGMMA_CHUNK
    return min((MAX_SMEM - _stats_fixed(d, kept)) // (2 * load),
               WGMMA_STATS_STAGES)


def wgmma_stats_kept(d: int) -> int:
    """sw_stats_kept: a stats block's kept rows, WGMMA_STATS_KEPT where its
    ring keeps two stages at D = d, else 64."""
    return (WGMMA_STATS_KEPT if _stats_stages(d, WGMMA_STATS_KEPT) >= 2
            else WGMMA_ROWS)


def wgmma_apply_chunks(d: int) -> int:
    """sw_apply_chunks: the apply's chunks a TMA load, eight (a key tile's
    whole K in one 64 KB load) at 256 < D <= 512, else four."""
    return (WGMMA_APPLY_CHUNKS if 4 * WGMMA_BOX < d <= WGMMA_COLS
            else WGMMA_APPLY_CHUNKS_S)


def wgmma_stages(d: int):
    """(stats, apply) ring stages at D = d (sw_stats_stages,
    sw_apply_stages): as many 32 KB stats stages (128 rows x 2 chunks)
    beside the kept tile (and, at 64 kept rows, the two warpgroups' (m,
    l)), and apply stages of 64 rows x `wgmma_apply_chunks` chunks beside
    Q and two P tiles, as fit in MAX_SMEM, at most 8 and 16."""
    ac = wgmma_apply_chunks(d)
    apply = (MAX_SMEM - _WGMMA_FIXED - _wgmma_chunks(d, ac) * _WGMMA_CHUNK
             - 2 * _WGMMA_CHUNK) // (ac * _WGMMA_CHUNK)
    return (_stats_stages(d, wgmma_stats_kept(d)),
            min(apply, WGMMA_APPLY_STAGES))


def wgmma_smem_bytes(d: int):
    """(stats, apply) dynamic shared memory at D = d with the kept rows of
    `wgmma_stats_kept` and the stages of `wgmma_stages`
    (sw_stats_smem_bytes, sw_apply_smem_bytes)."""
    s_st, a_st = wgmma_stages(d)
    ac = wgmma_apply_chunks(d)
    return (_stats_fixed(d, wgmma_stats_kept(d))
            + s_st * 2 * WGMMA_CHUNKS * _WGMMA_CHUNK,
            _WGMMA_FIXED + (_wgmma_chunks(d, ac) + 2) * _WGMMA_CHUNK
            + a_st * ac * _WGMMA_CHUNK)


def wgmma_plan(d: int):
    """sdm_streaming_wgmma_plan: (split, cols, stats kept rows, apply chunks
    a load) at D = d: the apply's column slices (sw_split: ceil(D / 512)
    slices of whole chunks), `wgmma_stats_kept` and
    `wgmma_apply_chunks`."""
    boxes = d // WGMMA_BOX
    split = -(-d // WGMMA_COLS)
    cols = -(-boxes // split) * WGMMA_BOX
    return split, cols, wgmma_stats_kept(d), wgmma_apply_chunks(d)


def admits_wgmma(dtype, s: int, d: int, ptrs, strides) -> bool:
    """sw_ok, the admission of both wgmma kernels (`ptrs` and `strides`,
    (sb, ss) in elements, of q and k for the stats; q, k, v and out for
    the apply): bf16, S % 64 == 0, D % 64 == 0 with 64 <= D <= 1024, at least
    two stats stages at 64 kept rows and, in the apply's ring, two stages
    and the V loads of a 512-column slice (sw_apply_min_stages), and
    16-byte aligned rows of every tensor."""
    if not (dtype == torch.bfloat16 and s > 0 and s % WGMMA_ROWS == 0
            and WGMMA_BOX <= d <= WGMMA_MAX_D and d % WGMMA_BOX == 0):
        return False
    min_stages = max(2, WGMMA_COLS // WGMMA_BOX // wgmma_apply_chunks(d))
    return (_stats_stages(d, WGMMA_ROWS) >= 2
            and wgmma_stages(d)[1] >= min_stages
            and rows_aligned16(ptrs, strides))


def da_load_chunks(d: int) -> int:
    """da_load_chunks: chunks a TMA load at D = d, DA_LOAD_CHUNKS where
    they divide D's 64-column chunks, else two."""
    return DA_LOAD_CHUNKS if (d // WGMMA_BOX) % DA_LOAD_CHUNKS == 0 else 2


def da_loads(d: int) -> int:
    """da_loads: TMA loads of D."""
    return d // WGMMA_BOX // da_load_chunks(d)


def _da_fixed(d: int) -> int:
    """da_fixed: the shared memory besides the ring, A and A2 (64 rows),
    two 64 x 64 dA tiles, the staged stats of two tiles (m, 1/l, corr a
    streamed row), alignment slack and barriers."""
    return (_WGMMA_FIXED + 2 * (d // WGMMA_BOX) * _WGMMA_CHUNK
            + 2 * _WGMMA_CHUNK + 2 * 3 * DA_TILE * 4)


def _da_load_bytes(d: int) -> int:
    return da_load_chunks(d) * DA_TILE * WGMMA_BOX * 2


def da_wgmma_stages(d: int) -> int:
    """da_stages: the ring stages of stream_da_wgmma at D = d, loads of
    DA_TILE rows x `da_load_chunks` chunks, as many as fit beside
    `_da_fixed` in MAX_SMEM, at most DA_STAGES."""
    return min((MAX_SMEM - _da_fixed(d)) // _da_load_bytes(d), DA_STAGES)


def da_wgmma_smem_bytes(d: int) -> int:
    """da_smem_bytes: stream_da_wgmma's dynamic shared memory at D = d with
    `da_wgmma_stages` stages."""
    return _da_fixed(d) + da_wgmma_stages(d) * _da_load_bytes(d)


def rows_aligned16(ptrs, strides) -> bool:
    """16-byte aligned base pointers and strides (each tensor's tuple: (sb,
    ss), or (sn, sh, ss)) that are multiples of 8 elements
    (csrc/attention_tiles.cuh rows_aligned16)."""
    return all(p % 16 == 0 and all(x % 8 == 0 for x in st)
               for p, st in zip(ptrs, strides))


def da_admits_wgmma(dtype, s: int, d: int, ptrs, strides) -> bool:
    """da_wgmma_ok: bf16, S % 64 == 0 (and % DA_TILE), D % 128 == 0 with
    0 < D <= 512, a ring of at least two stages, and 16-byte aligned rows
    of every tensor. `ptrs` and `strides` ((sb, ss) in elements) of q, k,
    v, g and out."""
    if not (dtype == torch.bfloat16 and s > 0 and s % DA_ROWS == 0
            and s % DA_TILE == 0 and 0 < d <= DA_MAX_D and d % 128 == 0):
        return False
    return da_wgmma_stages(d) >= 2 and rows_aligned16(ptrs, strides)


def _layout(*tensors):
    return ([t.data_ptr() for t in tensors],
            [(t.stride(0), t.stride(1)) for t in tensors])


def stats_takes_wgmma(q, k) -> bool:
    """Whether the stats pass on q, k runs on stream_stats_wgmma."""
    return admits_wgmma(q.dtype, q.shape[1], q.shape[2], *_layout(q, k))


def apply_takes_wgmma(q, k, v, out) -> bool:
    """Whether the apply pass on q, k, v into `out` runs on
    stream_apply_wgmma; so does the dV pass on q, k, g into `dv` where
    `apply_takes_wgmma(k, q, g, dv)` (its roles as sdm_streaming_dv swaps
    them; each tensor is checked alone)."""
    return admits_wgmma(q.dtype, q.shape[1], q.shape[2],
                        *_layout(q, k, v, out))


def da_takes_wgmma(q, k, v, g, out) -> bool:
    """Whether the dK or dQ pass on q, k, v, g (B, S, D) into `out` runs on
    stream_da_wgmma."""
    return da_admits_wgmma(q.dtype, q.shape[1], q.shape[2],
                           *_layout(q, k, v, g, out))


# Score tile of the plain versions, (TILE, TILE) per batch row: the TPU
# kernels' tile.
TILE = 256


def _scores(a, b, scale: float):
    """fp32 scale * a b^T for (B, Ta, D) x (B, Tb, D) -> (B, Ta, Tb)."""
    return torch.matmul(a.to(torch.float32),
                        b.to(torch.float32).transpose(-1, -2)) * scale


def _stat_tile(t, i0, j0, softmax_axis):
    """A (B, 1, S) per-key ("q") or per-query ("k") table cut to broadcast
    over the (B, Ti, Tj) tile at query i0, key j0."""
    if softmax_axis == "q":
        return t[:, :, j0:j0 + TILE]
    return t[:, 0, i0:i0 + TILE, None]


def _p_tile(q, k, m, l, i0, j0, scale, softmax_axis):
    """fp32 P = exp(s - m) / l of the (query i0, key j0) tile."""
    st = _scores(q[:, i0:i0 + TILE], k[:, j0:j0 + TILE], scale)
    return (torch.exp(st - _stat_tile(m, i0, j0, softmax_axis))
            / _stat_tile(l, i0, j0, softmax_axis))


def _round(x, dtype):
    """x rounded to `dtype` and widened back to fp32 (an astype(dtype))."""
    return x.to(dtype).to(torch.float32)


def streaming_stats_reference(q, k, scale: float, softmax_axis: str = "q"):
    """Plain version of the stats pass: (m, l), each (B, 1, S) fp32, merged
    online over TILE-sized chunks of the reduced axis."""
    kept, red = (k, q) if softmax_axis == "q" else (q, k)
    b, s, _ = q.shape
    m = torch.empty((b, 1, s), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    for a0 in range(0, s, TILE):
        mt = lt = None
        for r0 in range(0, s, TILE):
            st = _scores(kept[:, a0:a0 + TILE], red[:, r0:r0 + TILE], scale)
            cmax = st.amax(dim=-1)
            if mt is None:
                mt = cmax
                lt = torch.exp(st - cmax[..., None]).sum(dim=-1)
            else:
                mn = torch.maximum(mt, cmax)
                lt = (lt * torch.exp(mt - mn)
                      + torch.exp(st - mn[..., None]).sum(dim=-1))
                mt = mn
        m[:, 0, a0:a0 + TILE] = mt
        l[:, 0, a0:a0 + TILE] = lt
    return m, l


def streaming_apply_reference(q, k, v, m, l, scale: float,
                              softmax_axis: str = "q", out_dtype=None):
    """Plain version of the apply pass: per query tile, the sum over key
    tiles of P V_j with P = exp(s - m) / l rounded to v's dtype, fp32
    accumulation, one rounding to `out_dtype` (default q's dtype)."""
    b, s, d = q.shape
    out = torch.empty((b, s, d), dtype=out_dtype or q.dtype, device=q.device)
    for i0 in range(0, s, TILE):
        acc = 0
        for j0 in range(0, s, TILE):
            p = _round(_p_tile(q, k, m, l, i0, j0, scale, softmax_axis),
                       v.dtype)
            acc = acc + torch.matmul(p, v[:, j0:j0 + TILE].to(torch.float32))
        out[:, i0:i0 + TILE] = acc
    return out


def streaming_attention_reference(q, k, v, scale: float,
                                  softmax_axis: str = "q"):
    """Plain version of the whole forward: the two plain passes in turn."""
    m, l = streaming_stats_reference(q, k, scale, softmax_axis)
    return streaming_apply_reference(q, k, v, m, l, scale, softmax_axis)


def streaming_dv_reference(q, k, g, m, l, scale: float,
                           softmax_axis: str = "q"):
    """Plain version of the dV pass (`_dv_kernel`): per key tile, the sum
    over query tiles of round_g(P)^T g_i, g first cast to q's dtype, fp32
    accumulation and output."""
    g = g.to(q.dtype)
    b, s, d = q.shape
    dv = torch.empty((b, s, d), dtype=torch.float32, device=q.device)
    for j0 in range(0, s, TILE):
        acc = 0
        for i0 in range(0, s, TILE):
            p = _round(_p_tile(q, k, m, l, i0, j0, scale, softmax_axis),
                       g.dtype)
            acc = acc + torch.matmul(p.transpose(-1, -2),
                                     g[:, i0:i0 + TILE].to(torch.float32))
        dv[:, j0:j0 + TILE] = acc
    return dv


def _da_tile(q, k, v, g, m, l, corr, i0, j0, scale, softmax_axis):
    """dA = P (g v^T - corr) of the (query i0, key j0) tile, rounded to q's
    dtype (`_da_tile` and the astype before each product)."""
    p = _p_tile(q, k, m, l, i0, j0, scale, softmax_axis)
    dp = torch.matmul(g[:, i0:i0 + TILE].to(torch.float32),
                      v[:, j0:j0 + TILE].to(torch.float32).transpose(-1, -2))
    return _round(p * (dp - _stat_tile(corr, i0, j0, softmax_axis)), q.dtype)


def streaming_dk_reference(q, k, v, g, m, l, corr, scale: float,
                           softmax_axis: str = "q"):
    """Plain version of the dK pass (`_dk_kernel`): per key tile, the sum
    over query tiles of scale * dA^T q_i; fp32 output."""
    g = g.to(q.dtype)
    b, s, d = q.shape
    dk = torch.empty((b, s, d), dtype=torch.float32, device=q.device)
    for j0 in range(0, s, TILE):
        acc = 0
        for i0 in range(0, s, TILE):
            da = _da_tile(q, k, v, g, m, l, corr, i0, j0, scale,
                          softmax_axis)
            acc = acc + torch.matmul(da.transpose(-1, -2),
                                     q[:, i0:i0 + TILE].to(torch.float32)
                                     ) * scale
        dk[:, j0:j0 + TILE] = acc
    return dk


def streaming_dq_reference(q, k, v, g, m, l, corr, scale: float,
                           softmax_axis: str = "q"):
    """Plain version of the dQ pass (`_dq_kernel`): per query tile, the sum
    over key tiles of scale * dA k_j; fp32 output."""
    g = g.to(q.dtype)
    b, s, d = q.shape
    dq = torch.empty((b, s, d), dtype=torch.float32, device=q.device)
    for i0 in range(0, s, TILE):
        acc = 0
        for j0 in range(0, s, TILE):
            da = _da_tile(q, k, v, g, m, l, corr, i0, j0, scale,
                          softmax_axis)
            acc = acc + torch.matmul(
                da, k[:, j0:j0 + TILE].to(torch.float32)) * scale
        dq[:, i0:i0 + TILE] = acc
    return dq


def _check(what, softmax_axis, *tensors):
    """Shared argument checks of the CUDA wrappers; returns (B, S, D)."""
    _build.require_cuda(what, *tensors)
    if softmax_axis not in ("q", "k"):
        raise ValueError(f"{what}: softmax_axis must be 'q' or 'k'")
    shape = tensors[0].shape
    if len(shape) != 3 or any(t.shape != shape for t in tensors):
        raise ValueError(f"{what}: q, k, v and g must share one (B, S, D) "
                         f"shape, got {[tuple(t.shape) for t in tensors]}")
    if any(t.dtype != tensors[0].dtype for t in tensors):
        raise ValueError(f"{what}: q, k, v and g must share a dtype")
    if any(t.stride(2) != 1 for t in tensors):
        raise ValueError(f"{what}: q, k, v and g need a unit stride on D")
    return shape


def _check_stats(what, b, s, device, *tables):
    for t in tables:
        if (t.shape != (b, 1, s) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != device):
            raise ValueError(f"{what}: m, l (and corr) must be contiguous "
                             f"({b}, 1, {s}) float32 on {device}")


def _strides(*tensors):
    return (ctypes.c_longlong * (2 * len(tensors)))(*[
        st for t in tensors for st in (t.stride(0), t.stride(1))])


def _launch(symbol, what, device, args, ref, wgmma=False):
    """Launch `symbol` of the streaming library on `device`; raise on a
    CUDA error. `wgmma`: the launch runs a tensor-core kernel
    (stream_stats_wgmma, stream_apply_wgmma or stream_da_wgmma), counted
    in ref.mma_launches and ref.wgmma_launches."""
    lib = _build.library("streaming_attention", _SIGNATURES)
    with _build.on_device(device):
        rc = getattr(lib, symbol)(*args)
    _build.check(lib, rc, what)
    ref.launches += 1
    if wgmma:
        ref.mma_launches += 1
        ref.wgmma_launches += 1


def streaming_stats(q, k, scale: float, softmax_axis: str = "q"):
    """q, k (B, S, D) with a unit D stride. Returns (m, l), each (B, 1, S)
    fp32.

    CPU tensors run `streaming_stats_reference`; CUDA tensors launch
    csrc/streaming_attention.cu's stats pass or raise."""
    if q.device.type == "cpu":
        return streaming_stats_reference(q, k, scale, softmax_axis)
    what = "streaming_stats"
    b, s, d = _check(what, softmax_axis, q, k)
    m = torch.empty((b, 1, s), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    _launch("sdm_streaming_stats", what, q.device, (
        q.data_ptr(), k.data_ptr(), m.data_ptr(), l.data_ptr(),
        ctypes.cast(_strides(q, k), _P), b, s, d, float(scale),
        int(softmax_axis == "q"), _build.dtype_code(q, what),
        _build.stream_handle(q.device)), streaming_stats,
        wgmma=stats_takes_wgmma(q, k))
    return m, l


streaming_stats.launches = 0
streaming_stats.mma_launches = 0
streaming_stats.wgmma_launches = 0


def streaming_apply(q, k, v, m, l, scale: float, softmax_axis: str = "q",
                    out_dtype=None):
    """q, k, v (B, S, D) with a unit D stride; m, l the stats pass's (B, 1,
    S) fp32 for the same axis. Returns a contiguous (B, S, D) in
    `out_dtype`: q's dtype (default) or float32.

    CPU tensors run `streaming_apply_reference`; CUDA tensors launch
    csrc/streaming_attention.cu's apply pass or raise."""
    if q.device.type == "cpu":
        return streaming_apply_reference(q, k, v, m, l, scale, softmax_axis,
                                         out_dtype)
    what = "streaming_apply"
    b, s, d = _check(what, softmax_axis, q, k, v)
    _check_stats(what, b, s, q.device, m, l)
    out_dtype = out_dtype or q.dtype
    if out_dtype not in (q.dtype, torch.float32):
        raise ValueError(f"{what}: out_dtype must be q's dtype or float32")
    out = torch.empty((b, s, d), dtype=out_dtype, device=q.device)
    _launch("sdm_streaming_apply", what, q.device, (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        m.data_ptr(), l.data_ptr(), ctypes.cast(_strides(q, k, v, out), _P),
        b, s, d, float(scale), int(softmax_axis == "q"),
        _build.dtype_code(q, what), _build.dtype_code(out, what),
        _build.stream_handle(q.device)), streaming_apply,
        wgmma=apply_takes_wgmma(q, k, v, out))
    return out


streaming_apply.launches = 0
streaming_apply.mma_launches = 0
streaming_apply.wgmma_launches = 0


def streaming_dv(q, k, g, m, l, scale: float, softmax_axis: str = "q"):
    """dV = P^T g for q, k, g (B, S, D) in one dtype with a unit D stride
    (the caller casts g to q's dtype) and the forward's m, l. Returns fp32
    (B, S, D).

    CPU tensors run `streaming_dv_reference`; CUDA tensors launch
    csrc/streaming_attention.cu's dV pass or raise."""
    if q.device.type == "cpu":
        return streaming_dv_reference(q, k, g, m, l, scale, softmax_axis)
    what = "streaming_dv"
    b, s, d = _check(what, softmax_axis, q, k, g)
    _check_stats(what, b, s, q.device, m, l)
    dv = torch.empty((b, s, d), dtype=torch.float32, device=q.device)
    _launch("sdm_streaming_dv", what, q.device, (
        q.data_ptr(), k.data_ptr(), g.data_ptr(), dv.data_ptr(),
        m.data_ptr(), l.data_ptr(), ctypes.cast(_strides(q, k, g, dv), _P),
        b, s, d, float(scale), int(softmax_axis == "q"),
        _build.dtype_code(q, what), _build.stream_handle(q.device)),
        streaming_dv, wgmma=apply_takes_wgmma(k, q, g, dv))
    return dv


streaming_dv.launches = 0
streaming_dv.mma_launches = 0
streaming_dv.wgmma_launches = 0


def _launch_da(symbol, what, ref, q, k, v, g, m, l, corr, scale,
               softmax_axis):
    b, s, d = _check(what, softmax_axis, q, k, v, g)
    _check_stats(what, b, s, q.device, m, l, corr)
    out = torch.empty((b, s, d), dtype=torch.float32, device=q.device)
    _launch(symbol, what, q.device, (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        out.data_ptr(), m.data_ptr(), l.data_ptr(), corr.data_ptr(),
        ctypes.cast(_strides(q, k, v, g, out), _P), b, s, d, float(scale),
        int(softmax_axis == "q"), _build.dtype_code(q, what),
        _build.stream_handle(q.device)), ref,
        wgmma=da_takes_wgmma(q, k, v, g, out))
    return out


def streaming_dk(q, k, v, g, m, l, corr, scale: float,
                 softmax_axis: str = "q"):
    """dK = scale dA^T q, dA = P (g v^T - corr), for q, k, v, g (B, S, D) in
    one dtype with a unit D stride, the forward's m, l and corr (B, 1, S)
    fp32 (per key on the q axis, per query on the k axis). Returns fp32
    (B, S, D).

    CPU tensors run `streaming_dk_reference`; CUDA tensors launch
    csrc/streaming_attention.cu's dK pass or raise."""
    if q.device.type == "cpu":
        return streaming_dk_reference(q, k, v, g, m, l, corr, scale,
                                      softmax_axis)
    return _launch_da("sdm_streaming_dk", "streaming_dk", streaming_dk,
                      q, k, v, g, m, l, corr, scale, softmax_axis)


streaming_dk.launches = 0
streaming_dk.mma_launches = 0
streaming_dk.wgmma_launches = 0


def streaming_dq(q, k, v, g, m, l, corr, scale: float,
                 softmax_axis: str = "q"):
    """dQ = scale dA k, arguments as `streaming_dk`. Returns fp32 (B, S, D).

    CPU tensors run `streaming_dq_reference`; CUDA tensors launch
    csrc/streaming_attention.cu's dQ pass or raise."""
    if q.device.type == "cpu":
        return streaming_dq_reference(q, k, v, g, m, l, corr, scale,
                                      softmax_axis)
    return _launch_da("sdm_streaming_dq", "streaming_dq", streaming_dq,
                      q, k, v, g, m, l, corr, scale, softmax_axis)


streaming_dq.launches = 0
streaming_dq.mma_launches = 0
streaming_dq.wgmma_launches = 0


def streaming_correction(g, v, out32, dv, softmax_axis: str):
    """The softmax-Jacobian term (B, 1, S) fp32 that dK and dQ take: c_j =
    dV_j . v_j on the q axis, D_i = g_i . out_i on the k axis (the fp32
    forward output). Plain torch, as sdm_tpu leaves it to XLA (:347, :350)."""
    if softmax_axis == "q":
        return (dv * v.to(torch.float32)).sum(dim=-1)[:, None, :]
    return (g.to(torch.float32) * out32).sum(dim=-1)[:, None, :]


class StreamingAttention(torch.autograd.Function):
    """`_vjp_fwd`/`_vjp_bwd` (:328-355). Residuals: q, k, v, the stats m, l
    and, on the key axis, the fp32 forward output (D_i = g_i . out_i reads
    it; a rounded output would move the gradient). Backward: dV, then corr,
    then dK and dQ, each cast to its input's dtype."""

    @staticmethod
    def forward(ctx, q, k, v, scale, softmax_axis):
        m, l = streaming_stats(q, k, scale, softmax_axis)
        out32 = None
        if softmax_axis == "k":
            out32 = streaming_apply(q, k, v, m, l, scale, softmax_axis,
                                    out_dtype=torch.float32)
            out = out32.to(q.dtype)
        else:
            out = streaming_apply(q, k, v, m, l, scale, softmax_axis)
        ctx.save_for_backward(q, k, v, m, l, out32)
        ctx.scale, ctx.softmax_axis = scale, softmax_axis
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, m, l, out32 = ctx.saved_tensors
        scale, axis = ctx.scale, ctx.softmax_axis
        g_in = g.to(q.dtype)
        if g_in.stride(-1) != 1:
            g_in = g_in.contiguous()
        dv = streaming_dv(q, k, g_in, m, l, scale, axis)
        corr = streaming_correction(g, v, out32, dv, axis)
        dk = streaming_dk(q, k, v, g_in, m, l, corr, scale, axis)
        dq = streaming_dq(q, k, v, g_in, m, l, corr, scale, axis)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def streaming_attention(q, k, v, scale: float, softmax_axis: str = "q"):
    """(B, S, D) streaming attention, output in the input dtype: the stats
    pass, then the apply pass (each a kernel launch on CUDA, each its plain
    version on the CPU). When a gradient is wanted it runs as
    `StreamingAttention`, whose backward launches dV, dK and dQ."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return StreamingAttention.apply(q, k, v, scale, softmax_axis)
    m, l = streaming_stats(q, k, scale, softmax_axis)
    return streaming_apply(q, k, v, m, l, scale, softmax_axis)
