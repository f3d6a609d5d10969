"""U-Net building blocks (port of sdm_tpu/models/layers.py, torch.nn).

Module and parameter names are the reference's torch names, so a reference
or sdm_tpu checkpoint loads with `load_state_dict(strict=True)`, e.g.
`down_layers.0.res_layers.0.conv_block_1.conv_layer.0.weight` and the
`adagn.y_scale` / `adagn.y_shift` / `adagn.group_norm` children.

Activations are NCHW tensors in `torch.channels_last` memory format: cuDNN
convs run in their fast layout, and an NHWC view of any activation
(`x.permute(0, 2, 3, 1)`) is contiguous, which is what the AdaGN and
attention kernels take without a copy.

`parity=True` (the default) keeps the reference's quirks as sdm_tpu does:
AdaGN's shift comes from the y_scale projection (y_shift is dead weight),
the attention softmax runs over the query axis, and the attention block owns
a GroupNorm `norm` that is never applied.

`dtype` is the compute dtype (None = the input's), with sdm_tpu's rounding
points: TorchLinear accumulates in fp32, adds the fp32 bias, then casts;
convs run in the compute dtype. `use_kernels` routes AdaGN to
`fused_adagn`, single-head attention to `fused_attention_block` and
multi-head attention to `fused_attention`; without it the layers run the
plain composed PyTorch path.

Model parallelism (parallel/tp.py, parallel/sp.py). A conv, transposed
conv or linear whose weight is a tensor-parallel shard (its `tp` set by
tp.shard_model; `tp_out_dim` names the weight's output-channel dim) runs
column-parallel, and an attention block gathers whole weights for its
kernel. Inside sp.spatial(...) each layer works on an H slab: convs take
their halo rows, GroupNorm and attention reduce over the space group.
Neither changes a layer's one-device path.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from sdm_tpu_torch.enums import UNetBlockType
from sdm_tpu_torch.kernels.adagn import fused_adagn
from sdm_tpu_torch.kernels.attention import attention
from sdm_tpu_torch.kernels.attention_block import fused_attention_block
from sdm_tpu_torch.ops.norms import group_norm
from sdm_tpu_torch.parallel import sp, tp


def remat_call(fn, *args, remat: bool = False):
    """fn(*args), under `remat` a checkpoint whenever autograd records:
    only the inputs are kept, and the backward runs fn again (sdm_tpu's
    nn.checkpoint), inside the SP context the first run saw. No layer
    draws random numbers, so the replay equals the first run; the RNG
    state is still preserved around it."""
    if remat and torch.is_grad_enabled():
        shard = sp.active()
        return checkpoint(fn, *args, use_reentrant=False, context_fn=lambda: (
            contextlib.nullcontext(), sp.spatial(shard)))
    return fn(*args)


def swish(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) (reference custom_layers.py:18-20)."""
    return x * torch.sigmoid(x)


class Swish(nn.Module):
    def forward(self, x):
        return swish(x)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """NHWC view of an NCHW activation; contiguous when x is channels_last."""
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _no_kernels(use_kernels: bool, what: str) -> None:
    """The kernels take whole images: inside an SP context a layer built
    with them raises (the trainers and generators build their U-Nets with
    use_kernels=False under sp > 1)."""
    if use_kernels:
        raise RuntimeError(f"{what}: the kernels run on whole images; build "
                           "the U-Net with use_kernels=False under spatial "
                           "partitioning")


class TorchLinear(nn.Module):
    """nn.Linear parameters and init; fp32 accumulation, fp32 bias, one
    rounding to the compute dtype (sdm_tpu layers.py:62-64)."""

    tp_out_dim = 0
    tp = None

    def __init__(self, in_features: int, out_features: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        bound = 1.0 / math.sqrt(in_features)
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features).uniform_(-bound, bound))
        self.bias = nn.Parameter(
            torch.empty(out_features).uniform_(-bound, bound))

    def forward(self, x):
        dtype = self.dtype or x.dtype
        x = x.to(dtype).to(torch.float32)
        if self.tp is not None:
            y = tp.column(self, x, lambda x, w: F.linear(
                x, w.to(dtype).to(torch.float32)), -1)
            return (y + self.bias.to(torch.float32)).to(dtype)
        y = F.linear(x, self.weight.to(dtype).to(torch.float32),
                     self.bias.to(torch.float32))
        return y.to(dtype)


def _conv(layer, x, dtype, conv, transposed: bool):
    """A conv layer's forward, conv(x, weight, bias, padding) in `dtype`:
    on one device as it is; under SP with halo rows (H padding 0, or the
    transposed conv's); under TP column-parallel, the bias added whole."""
    padding = layer.padding
    shard = sp.active()
    if shard is not None:
        above, below, pad_h = sp.conv_halo(layer.kernel_size[0],
                                           layer.stride[0], layer.padding[0],
                                           transposed)
        x = sp.halo(x, shard, above, below)
        padding = (pad_h, layer.padding[1])
    if layer.tp is None:
        return conv(x, layer.weight.to(dtype), layer.bias.to(dtype), padding)
    y = tp.column(layer, x, lambda x, w: conv(x, w.to(dtype), None,
                                              padding), 1)
    return y + layer.bias.to(dtype)[None, :, None, None]


class TorchConv(nn.Conv2d):
    """nn.Conv2d run in the compute dtype."""

    tp_out_dim = 0
    tp = None

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, dtype=None):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride,
                         padding=padding)
        self.compute_dtype = dtype

    def forward(self, x):
        dtype = self.compute_dtype or x.dtype
        return _conv(
            self, x.to(dtype), dtype,
            lambda x, w, b, p: F.conv2d(x, w, b, self.stride, p), False)


class TorchConvTranspose(nn.ConvTranspose2d):
    """nn.ConvTranspose2d (weight (in, out, kh, kw)) run in the compute
    dtype."""

    tp_out_dim = 1
    tp = None

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 4,
                 stride: int = 2, padding: int = 1, dtype=None):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride,
                         padding=padding)
        self.compute_dtype = dtype

    def forward(self, x):
        dtype = self.compute_dtype or x.dtype
        return _conv(
            self, x.to(dtype), dtype,
            lambda x, w, b, p: F.conv_transpose2d(x, w, b, self.stride, p),
            True)


class TorchGroupNorm(nn.Module):
    """GroupNorm (torch semantics) with an optional FiLM epilogue
    `mod_scale * GN(x) + mod_shift`, per sample (mod tables (N, C) or
    (1, C)). With `use_kernels` the FiLM form runs `fused_adagn`."""

    def __init__(self, channels: int, num_groups: int = 32,
                 eps: float = 1e-5, use_kernels: bool = False):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.use_kernels = use_kernels
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, mod_scale=None, mod_shift=None):
        xh = _nhwc(x)
        shard = sp.active()
        if shard is not None:
            _no_kernels(self.use_kernels and mod_scale is not None, "AdaGN")
            out = sp.group_norm(xh, self.weight, self.bias, self.num_groups,
                                self.eps, shard)
        elif mod_scale is not None and self.use_kernels:
            out = fused_adagn(xh.contiguous(), self.weight, self.bias,
                              mod_scale, mod_shift, self.num_groups, self.eps)
            return _nchw(out)
        else:
            out = group_norm(xh, self.weight, self.bias, self.num_groups,
                             self.eps)
        if mod_scale is not None:
            out = (mod_scale[:, None, None, :] * out
                   + mod_shift[:, None, None, :])
        return _nchw(out)


class AdaGN(nn.Module):
    """GroupNorm then FiLM from the embedding (custom_layers.py:26-45).
    parity=True takes the shift from y_scale (the reference bug)."""

    def __init__(self, emb_dim: int, out_dim: int, groups: int = 32,
                 parity: bool = True, use_kernels: bool = True, dtype=None):
        super().__init__()
        self.parity = parity
        self.y_scale = TorchLinear(emb_dim, out_dim, dtype=dtype)
        self.y_shift = TorchLinear(emb_dim, out_dim, dtype=dtype)
        self.group_norm = TorchGroupNorm(out_dim, groups,
                                         use_kernels=use_kernels)

    def forward(self, x, emb):
        scale = self.y_scale(emb)
        shift = scale if self.parity else self.y_shift(emb)
        return self.group_norm(x, scale, shift)


class ConditionalEmbedding(nn.Module):
    """Sinusoidal time embedding + 4-Linear/Swish MLP, plus an optional
    conditional-vector MLP that is added (custom_layers.py:51-98)."""

    def __init__(self, time_dim: int, cond_dim: Optional[int] = None,
                 dtype=None):
        super().__init__()
        self.time_dim = time_dim
        self.dtype = dtype

        def mlp(in_dim):
            return nn.Sequential(
                TorchLinear(in_dim, time_dim, dtype), Swish(),
                TorchLinear(time_dim, time_dim, dtype), Swish(),
                TorchLinear(time_dim, time_dim, dtype), Swish(),
                TorchLinear(time_dim, time_dim, dtype))

        self.time_layer = mlp(time_dim)
        self.cond_layer = mlp(cond_dim) if cond_dim is not None else None

    def forward(self, t, cond=None):
        half_dim = self.time_dim // 2
        freq_scale = math.log(10_000) / (half_dim - 1)
        freqs = torch.exp(torch.arange(half_dim, dtype=torch.float32,
                                       device=t.device) * -freq_scale)
        te = t.to(torch.float32)[:, None] * freqs[None, :]
        te = torch.cat([torch.sin(te), torch.cos(te)], dim=1)
        if self.dtype is not None:
            te = te.to(self.dtype)
        te = self.time_layer(te)
        if self.cond_layer is not None:
            ce = cond if self.dtype is None else cond.to(self.dtype)
            te = te + self.cond_layer(ce)
        return te


class AttentionBlock(nn.Module):
    """Multi-head self-attention over flattened H*W tokens with a residual
    (custom_layers.py:104-163). d_k=None means d_k = channels."""

    def __init__(self, channels: int, heads: int = 1,
                 d_k: Optional[int] = None, groups: int = 32,
                 parity: bool = True, use_kernels: bool = True, dtype=None):
        super().__init__()
        self.heads = heads
        self.d_k = d_k if d_k is not None else channels
        self.parity = parity
        self.use_kernels = use_kernels
        self.dtype = dtype
        self.norm = TorchGroupNorm(channels, groups)   # dead weight
        self.projection = TorchLinear(channels, heads * self.d_k * 3, dtype)
        self.output = TorchLinear(heads * self.d_k, channels, dtype)

    def forward(self, x, t=None):
        del t
        n, c, h, w = x.shape
        d_k, heads = self.d_k, self.heads
        scale = d_k ** -0.5
        axis = "q" if self.parity else "k"
        dtype = self.dtype or x.dtype
        tokens = _nhwc(x).reshape(n, h * w, c)
        shard = sp.active()
        _no_kernels(self.use_kernels and shard is not None, "attention")
        if self.use_kernels and heads == 1:
            # Under TP the kernel takes the whole (gathered) weights.
            res = fused_attention_block(
                tokens.to(dtype).contiguous(),
                tp.full_weight(self.projection).to(dtype),
                self.projection.bias,
                tp.full_weight(self.output).to(dtype), self.output.bias,
                scale, axis)
            return _nchw(res.reshape(n, h, w, c))
        qkv = self.projection(tokens).reshape(n, h * w, heads, 3 * d_k)
        q, k, v = qkv.split(d_k, dim=-1)
        if shard is not None:
            res = sp.attention(q, k, v, scale, axis, shard)
        else:
            res = attention(q, k, v, scale, axis,
                            use_kernels=self.use_kernels)
        res = self.output(res.reshape(n, h * w, heads * d_k)) + tokens
        return _nchw(res.reshape(n, h, w, c))


class UpsampleBlock(nn.Module):
    """ConvTranspose(k=4, s=2, p=1) + Swish (custom_layers.py:169-185)."""

    def __init__(self, in_ch: int, out_ch: int, dtype=None):
        super().__init__()
        self.conv_layer = nn.Sequential(
            TorchConvTranspose(in_ch, out_ch, 4, 2, 1, dtype), Swish())

    def forward(self, x, emb=None):
        return self.conv_layer(x)


class DownsampleBlock(nn.Module):
    """Conv(k=3, s=2, p=1) + Swish (custom_layers.py:191-207)."""

    def __init__(self, in_ch: int, out_ch: int, dtype=None):
        super().__init__()
        self.conv_layer = nn.Sequential(
            TorchConv(in_ch, out_ch, 3, 2, 1, dtype), Swish())

    def forward(self, x, emb=None):
        return self.conv_layer(x)


class UNetConvBlock(nn.Module):
    """Conv(k=3, p=1) [+ Swish], then AdaGN when emb_dim is set
    (custom_layers.py:213-245)."""

    def __init__(self, in_ch: int, out_ch: int, use_activation: bool = True,
                 emb_dim: Optional[int] = None, groups: int = 32,
                 parity: bool = True, use_kernels: bool = True, dtype=None):
        super().__init__()
        layers = [TorchConv(in_ch, out_ch, 3, 1, 1, dtype)]
        if use_activation:
            layers.append(Swish())
        self.conv_layer = nn.Sequential(*layers)
        self.adagn = (AdaGN(emb_dim, out_ch, groups, parity, use_kernels,
                            dtype) if emb_dim is not None else None)

    def forward(self, x, emb=None):
        x = self.conv_layer(x)
        if self.adagn is not None:
            if emb is None:
                raise ValueError("UNetConvBlock built with emb_dim needs emb.")
            x = self.adagn(x, emb)
        return x


class ResidualBlock(nn.Module):
    """Two conv blocks + (1x1 conv | identity) shortcut
    (custom_layers.py:251-287)."""

    def __init__(self, in_ch: int, out_ch: int, use_activation: bool = True,
                 emb_dim: Optional[int] = None, groups: int = 32,
                 parity: bool = True, use_kernels: bool = True, dtype=None):
        super().__init__()
        common = (use_activation, emb_dim, groups, parity, use_kernels, dtype)
        self.conv_block_1 = UNetConvBlock(in_ch, out_ch, *common)
        self.conv_block_2 = UNetConvBlock(out_ch, out_ch, *common)
        self.shortcut = (TorchConv(in_ch, out_ch, 1, 1, 0, dtype)
                         if in_ch != out_ch else None)

    def forward(self, x, emb=None):
        init_x = x
        x = self.conv_block_1(x, emb)
        x = self.conv_block_2(x, emb)
        shortcut = self.shortcut(init_x) if self.shortcut is not None \
            else init_x
        return x + shortcut


class UNetBlock(nn.Module):
    """num_resnet_blocks x (ResidualBlock -> Attention | identity) at the
    input width, then a Down-/Upsample to out_ch (custom_layers.py:293-341).
    With `remat` each of those sublayers is its own checkpoint, nested in
    the U-Net's checkpoint of the whole block, so the block's backward
    holds one sublayer's activations at a time (sdm_tpu layers.py:427-445)."""

    def __init__(self, in_ch: int, out_ch: int, num_resnet_blocks: int = 1,
                 use_attn: bool = True, num_heads: int = 1,
                 dim_per_head: Optional[int] = None, groups: int = 32,
                 block_type: UNetBlockType = UNetBlockType.DOWN,
                 emb_dim: Optional[int] = None, parity: bool = True,
                 use_kernels: bool = True, dtype=None, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.res_layers = nn.ModuleList([
            ResidualBlock(in_ch, in_ch, True, emb_dim, groups, parity,
                          use_kernels, dtype)
            for _ in range(num_resnet_blocks)])
        self.attn_layers = nn.ModuleList([
            AttentionBlock(in_ch, num_heads, dim_per_head, groups, parity,
                           use_kernels, dtype)
            for _ in range(num_resnet_blocks)]) if use_attn else None
        Smp = (DownsampleBlock if block_type == UNetBlockType.DOWN
               else UpsampleBlock)
        self.out_layer = Smp(in_ch, out_ch, dtype)

    def forward(self, x, emb=None):
        for j, res in enumerate(self.res_layers):
            x = remat_call(res, x, emb, remat=self.remat)
            if self.attn_layers is not None:
                x = remat_call(self.attn_layers[j], x, remat=self.remat)
        return remat_call(self.out_layer, x, remat=self.remat)
