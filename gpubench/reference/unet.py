"""The plain float32 U-Net the benchmark holds the served and trained
results to.

A functional forward over a flat {name: tensor} dict of parameters, in the
parameter names of the published U-Net (github.com/Vinmwaura/
Simple-Diffusion-Model, U_Net.py and custom_layers.py), with its quirks:
AdaGN's shift is its y_scale projection (y_shift is dead weight), the
attention softmax runs over the query axis, and the attention block's
GroupNorm `norm` is never applied.

Everything is float32 plain PyTorch; matmuls and convolutions run with TF32
off (`strict_fp32`). `quant`, when given, rounds the operands and the
result of every convolution, linear layer and attention product (and,
under autograd, their gradients): the control that computes the reference
in a lower precision.

This module imports nothing of the program under test.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


@contextlib.contextmanager
def strict_fp32():
    """float32 matmuls and convolutions without TF32, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def channel_schedule(cfg: dict) -> list:
    ch, c = [cfg["min_channel"]], cfg["min_channel"]
    for _ in range(cfg["num_layers"]):
        c *= 2
        ch.append(min(c, cfg["max_channel"]))
    return ch


def param_shapes(cfg: dict) -> Dict[str, tuple]:
    """{name: shape} of every parameter, in the program's state-dict
    order."""
    shapes: Dict[str, tuple] = {}
    ch = channel_schedule(cfg)
    td = cfg["time_dim"]

    def lin(name, i, o):
        shapes[f"{name}.weight"] = (o, i)
        shapes[f"{name}.bias"] = (o,)

    def conv(name, i, o, k):
        shapes[f"{name}.weight"] = (o, i, k, k)
        shapes[f"{name}.bias"] = (o,)

    def convt(name, i, o, k):
        shapes[f"{name}.weight"] = (i, o, k, k)
        shapes[f"{name}.bias"] = (o,)

    for j in (0, 2, 4, 6):
        lin(f"cond_emb.time_layer.{j}", td, td)
    conv("in_layer.0.conv_layer.0", cfg["in_channel"], ch[0], 3)
    conv("in_layer.1.conv_layer.0", ch[0], ch[0], 3)

    def block(name, c_in, c_out, attn, down):
        for r in range(cfg["num_resnet_blocks"]):
            res = f"{name}.res_layers.{r}"
            for cb in ("conv_block_1", "conv_block_2"):
                conv(f"{res}.{cb}.conv_layer.0", c_in, c_in, 3)
                lin(f"{res}.{cb}.adagn.y_scale", td, c_in)
                lin(f"{res}.{cb}.adagn.y_shift", td, c_in)
                shapes[f"{res}.{cb}.adagn.group_norm.weight"] = (c_in,)
                shapes[f"{res}.{cb}.adagn.group_norm.bias"] = (c_in,)
        if attn:
            for r in range(cfg["num_resnet_blocks"]):
                a = f"{name}.attn_layers.{r}"
                shapes[f"{a}.norm.weight"] = (c_in,)
                shapes[f"{a}.norm.bias"] = (c_in,)
                lin(f"{a}.projection", c_in, 3 * c_in)
                lin(f"{a}.output", c_in, c_in)
        if down:
            conv(f"{name}.out_layer.conv_layer.0", c_in, c_out, 3)
        else:
            convt(f"{name}.out_layer.conv_layer.0", c_in, c_out, 4)

    layers = cfg["num_layers"]
    for i in range(layers):
        block(f"down_layers.{i}", ch[i], ch[i + 1], i in cfg["attn_layers"],
              True)
    conv("middle_layer.0.conv_layer.0", ch[-1], ch[-1], 3)
    conv("middle_layer.1.conv_layer.0", ch[-1], ch[-1], 3)
    for u, i in enumerate(range(layers - 1, -1, -1)):
        block(f"up_layers.{u}", 2 * ch[i + 1], ch[i],
              i in cfg["attn_layers"], False)
    conv("out_layers.0.conv_layer.0", ch[0], ch[0], 3)
    conv("out_layers.1.conv_layer.0", ch[0], cfg["out_channel"], 3)
    return shapes


def init_bounds(shapes: Dict[str, tuple]) -> Dict[str, Optional[float]]:
    """Each parameter's uniform bound under PyTorch's default init
    (1/sqrt(fan_in), fan_in = dim 1 times the kernel, for weights and their
    biases); None for the GroupNorms' scales (1) and shifts (0)."""
    bounds: Dict[str, Optional[float]] = {}
    for name, shape in shapes.items():
        owner, leaf = name.rsplit(".", 1)
        w = shapes.get(f"{owner}.weight")
        if w is None or len(w) < 2:
            bounds[name] = None
            continue
        fan_in = w[1] * math.prod(w[2:])
        bounds[name] = 1.0 / math.sqrt(fan_in)
    return bounds


def _id(x):
    return x


def swish(x):
    return x * torch.sigmoid(x)


def _linear(p, name, x, q):
    return q(F.linear(q(x), q(p[f"{name}.weight"]), p[f"{name}.bias"]))


def _conv(p, name, x, q, stride=1, padding=1):
    return q(F.conv2d(q(x), q(p[f"{name}.weight"]), p[f"{name}.bias"],
                      stride=stride, padding=padding))


def time_embedding(p, cfg, t, q):
    half = cfg["time_dim"] // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32,
                                   device=t.device)
                      * -(math.log(10_000) / (half - 1)))
    te = t.to(torch.float32)[:, None] * freqs[None, :]
    te = torch.cat([torch.sin(te), torch.cos(te)], dim=1)
    for j in (0, 2, 4):
        te = swish(_linear(p, f"cond_emb.time_layer.{j}", te, q))
    return _linear(p, "cond_emb.time_layer.6", te, q)


def adagn(p, name, x, emb, groups, q):
    """GroupNorm (eps 1e-5, its own affine), then scale * GN + scale with
    scale = y_scale(emb): the published shift bug."""
    scale = _linear(p, f"{name}.y_scale", emb, q)[:, :, None, None]
    h = F.group_norm(x, groups, p[f"{name}.group_norm.weight"],
                     p[f"{name}.group_norm.bias"], eps=1e-5)
    return scale * h + scale


def attention(p, name, x, q):
    """Single-head self-attention over the H*W tokens, softmax over the
    query axis, output projection and residual."""
    n, c, h, w = x.shape
    tokens = x.permute(0, 2, 3, 1).reshape(n, h * w, c)
    qkv = _linear(p, f"{name}.projection", tokens, q)
    qq, kk, vv = qkv.split(c, dim=-1)
    scores = q(torch.matmul(q(qq), q(kk).transpose(1, 2))) * c ** -0.5
    probs = torch.softmax(scores, dim=1)          # over the queries
    r = q(torch.matmul(q(probs), q(vv)))
    out = _linear(p, f"{name}.output", r, q) + tokens
    return out.reshape(n, h, w, c).permute(0, 3, 1, 2)


def unet_block(p, cfg, name, x, emb, attn, down, q):
    groups = cfg["groups"]
    for r in range(cfg["num_resnet_blocks"]):
        res = f"{name}.res_layers.{r}"
        h = x
        for cb in ("conv_block_1", "conv_block_2"):
            h = swish(_conv(p, f"{res}.{cb}.conv_layer.0", h, q))
            h = adagn(p, f"{res}.{cb}.adagn", h, emb, groups, q)
        x = h + x
        if attn:
            x = attention(p, f"{name}.attn_layers.{r}", x, q)
    out = f"{name}.out_layer.conv_layer.0"
    if down:
        return swish(_conv(p, out, x, q, stride=2))
    return swish(q(F.conv_transpose2d(q(x), q(p[f"{out}.weight"]),
                                      p[f"{out}.bias"], stride=2,
                                      padding=1)))


def unet(p: Params, cfg: dict, x: torch.Tensor, t: torch.Tensor,
         quant: Quant = None) -> torch.Tensor:
    """x (N, H, W, C_in) float32, t (N,) or (1,) integer steps ->
    (N, H, W, C_out) float32."""
    q = quant or _id
    emb = time_embedding(p, cfg, t, q)
    h = x.permute(0, 3, 1, 2)
    for j in (0, 1):
        h = swish(_conv(p, f"in_layer.{j}.conv_layer.0", h, q))
    skips = []
    layers = cfg["num_layers"]
    for i in range(layers):
        h = unet_block(p, cfg, f"down_layers.{i}", h, emb,
                       i in cfg["attn_layers"], True, q)
        skips.append(h)
    for j in (0, 1):
        h = swish(_conv(p, f"middle_layer.{j}.conv_layer.0", h, q))
    for u, i in enumerate(range(layers - 1, -1, -1)):
        h = torch.cat([h, skips.pop()], dim=1)
        h = unet_block(p, cfg, f"up_layers.{u}", h, emb,
                       i in cfg["attn_layers"], False, q)
    h = swish(_conv(p, "out_layers.0.conv_layer.0", h, q))
    h = _conv(p, "out_layers.1.conv_layer.0", h, q)
    if cfg["image_recon"]:
        h = torch.tanh(h)
    return h.permute(0, 2, 3, 1)


FP8_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Fp8Round(torch.autograd.Function):
    """Rounds the value forward and its gradient backward."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor (its largest
    magnitude to the format's 448), back in float32, and under autograd its
    gradient rounded the same way: the control's precision for a bfloat16
    configuration."""
    return _Fp8Round.apply(x)
