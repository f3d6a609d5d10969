"""Streaming (two-pass) attention forward over (B, S, D), softmax over the
query axis ("q", the reference's parity quirk) or the key axis ("k").

Port of the forward of sdm_tpu/kernels/streaming_attention.py::
streaming_attention (`_forward`, :205-243): the stats pass (`_stats_kernel`
:97-112, launched at :223) and the apply pass (`_apply_kernel` :120-130,
launched at :234). The CUDA kernels are csrc/streaming_attention.cu: the
stats pass reuses the whole-S kernel's online (m, l) kernels, and the apply
pass walks key tiles with the final stats, so neither holds more than one
score tile and shared memory does not depend on S. The whole-S kernel
(kernels/attention.py) keeps a 32 x S block of P and stops fitting at the
256x256 SR model's S = 4096; the dispatchers send such shapes here. Both
passes are bound by operations (2*S*S*D for the stats, 4*S*S*D for the
apply pass, per batch row).

  streaming_stats(q, k, scale, axis) -> (m, l), each (B, 1, S) fp32: the
      running max and denominator over the reduced axis (per key for "q",
      per query for "k"), merged tile by tile.
  streaming_apply(q, k, v, m, l, scale, axis) -> out (B, S, D):
      sum_j round_v(exp(s_ij - m) / l) v_j, fp32 accumulation, one rounding
      to the input dtype (the TPU kernel writes fp32 and
      `streaming_attention` casts; here the cast is the apply pass's store).
  streaming_attention(q, k, v, scale, axis): the two in turn.

Each has a plain PyTorch version (`*_reference`) that runs tile by tile, as
the TPU kernels do, so it never holds an S x S score matrix either. The
wrappers take it only for CPU tensors; on CUDA tensors they launch the
kernel or raise. The backward kernels (`_dv`, `_backward`) belong to the
training slice.
"""

from __future__ import annotations

import ctypes

import torch

from sdm_tpu_torch.kernels import _build

_SIGNATURES = {
    "sdm_streaming_stats": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
    "sdm_streaming_apply": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
}

# Score tile of the plain versions, (TILE, TILE) per batch row: the TPU
# kernels' tile.
TILE = 256


def _scores(a, b, scale: float):
    """fp32 scale * a b^T for (B, Ta, D) x (B, Tb, D) -> (B, Ta, Tb)."""
    return torch.matmul(a.to(torch.float32),
                        b.to(torch.float32).transpose(-1, -2)) * scale


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
                              softmax_axis: str = "q"):
    """Plain version of the apply pass: per query tile, the sum over key
    tiles of P V_j with P = exp(s - m) / l rounded to v's dtype, fp32
    accumulation, one rounding to q's dtype."""
    b, s, d = q.shape
    out = torch.empty((b, s, d), dtype=q.dtype, device=q.device)
    for i0 in range(0, s, TILE):
        acc = None
        for j0 in range(0, s, TILE):
            st = _scores(q[:, i0:i0 + TILE], k[:, j0:j0 + TILE], scale)
            if softmax_axis == "q":      # per-key stats, broadcast over rows
                mm, ll = m[:, :, j0:j0 + TILE], l[:, :, j0:j0 + TILE]
            else:                        # per-query stats, over columns
                mm = m[:, 0, i0:i0 + TILE, None]
                ll = l[:, 0, i0:i0 + TILE, None]
            p = (torch.exp(st - mm) / ll).to(v.dtype).to(torch.float32)
            o = torch.matmul(p, v[:, j0:j0 + TILE].to(torch.float32))
            acc = o if acc is None else acc + o
        out[:, i0:i0 + TILE] = acc.to(q.dtype)
    return out


def streaming_attention_reference(q, k, v, scale: float,
                                  softmax_axis: str = "q"):
    """Plain version of the whole function: the two plain passes in turn."""
    m, l = streaming_stats_reference(q, k, scale, softmax_axis)
    return streaming_apply_reference(q, k, v, m, l, scale, softmax_axis)


def _check(what, softmax_axis, *tensors):
    """Shared argument checks of the CUDA wrappers; returns (B, S, D)."""
    _build.require_cuda(what, *tensors)
    if softmax_axis not in ("q", "k"):
        raise ValueError(f"{what}: softmax_axis must be 'q' or 'k'")
    shape = tensors[0].shape
    if len(shape) != 3 or any(t.shape != shape for t in tensors):
        raise ValueError(f"{what}: q, k (and v) must share one (B, S, D) "
                         f"shape, got {[tuple(t.shape) for t in tensors]}")
    if any(t.dtype != tensors[0].dtype for t in tensors):
        raise ValueError(f"{what}: q, k (and v) must share a dtype")
    if any(t.stride(2) != 1 for t in tensors):
        raise ValueError(f"{what}: q, k (and v) need a unit stride on D")
    return shape


def _check_stats(what, m, l, b, s, device):
    for t in (m, l):
        if (t.shape != (b, 1, s) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != device):
            raise ValueError(f"{what}: m and l must be contiguous "
                             f"({b}, 1, {s}) float32 on {device}")


def _strides(*tensors):
    return (ctypes.c_longlong * (2 * len(tensors)))(*[
        st for t in tensors for st in (t.stride(0), t.stride(1))])


def streaming_stats(q, k, scale: float, softmax_axis: str = "q"):
    """q, k (B, S, D) with a unit D stride. Returns (m, l), each (B, 1, S)
    fp32.

    CPU tensors run `streaming_stats_reference`; CUDA tensors launch
    csrc/streaming_attention.cu's stats pass or raise."""
    if q.device.type == "cpu":
        return streaming_stats_reference(q, k, scale, softmax_axis)
    what = "streaming_stats"
    b, s, d = _check(what, softmax_axis, q, k)
    code = _build.dtype_code(q, what)
    m = torch.empty((b, 1, s), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    strides = _strides(q, k)
    lib = _build.library("streaming_attention", _SIGNATURES)
    rc = lib.sdm_streaming_stats(
        q.data_ptr(), k.data_ptr(), m.data_ptr(), l.data_ptr(),
        ctypes.cast(strides, ctypes.c_void_p), b, s, d, float(scale),
        int(softmax_axis == "q"), code, _build.stream_handle(q.device))
    _build.check(lib, rc, what)
    streaming_stats.launches += 1
    return m, l


streaming_stats.launches = 0


def streaming_apply(q, k, v, m, l, scale: float, softmax_axis: str = "q"):
    """q, k, v (B, S, D) with a unit D stride; m, l the stats pass's (B, 1,
    S) fp32 for the same axis. Returns a contiguous (B, S, D) in q's dtype.

    CPU tensors run `streaming_apply_reference`; CUDA tensors launch
    csrc/streaming_attention.cu's apply pass or raise."""
    if q.device.type == "cpu":
        return streaming_apply_reference(q, k, v, m, l, scale, softmax_axis)
    what = "streaming_apply"
    b, s, d = _check(what, softmax_axis, q, k, v)
    _check_stats(what, m, l, b, s, q.device)
    code = _build.dtype_code(q, what)
    out = torch.empty((b, s, d), dtype=q.dtype, device=q.device)
    strides = _strides(q, k, v, out)
    lib = _build.library("streaming_attention", _SIGNATURES)
    rc = lib.sdm_streaming_apply(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        m.data_ptr(), l.data_ptr(), ctypes.cast(strides, ctypes.c_void_p),
        b, s, d, float(scale), int(softmax_axis == "q"), code,
        _build.stream_handle(q.device))
    _build.check(lib, rc, what)
    streaming_apply.launches += 1
    return out


streaming_apply.launches = 0


def streaming_attention(q, k, v, scale: float, softmax_axis: str = "q"):
    """(B, S, D) streaming attention, output in the input dtype: the stats
    pass, then the apply pass (each a kernel launch on CUDA, each its plain
    version on the CPU)."""
    m, l = streaming_stats(q, k, scale, softmax_axis)
    return streaming_apply(q, k, v, m, l, scale, softmax_axis)
