"""Operations and bytes of the U-Net and of the port's kernel functions,
counted from shapes: what is computed, not how a kernel computes it.

`unet_forward_flops` counts what torch.utils.flop_counter counts (two per
multiply-add of every convolution, linear layer and attention product).
`kernel_work` lists, per U-Net call, each call of the port's kernel
functions with its operations and the bytes it must move at least (each
input read once, each output written once), so that a roofline share is
the least time of that work over the time the card took for it.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from gpubench.reference.unet import channel_schedule

Work = Tuple[float, float]        # (operations, bytes)
# The most tokens the port's whole-S attention takes in bf16; blocks past
# it stream, and their backward runs the streaming dV, dK and dQ passes.
WHOLE_S_MAX = 3200


def levels(cfg: dict, h: int, w: int):
    """(name, channels, height, width, attention) of every UNetBlock's
    residual width, down then up, in call order."""
    ch = channel_schedule(cfg)
    out = []
    for i in range(cfg["num_layers"]):
        out.append((f"down{i}", ch[i], h >> i, w >> i,
                    i in cfg["attn_layers"]))
    for i in range(cfg["num_layers"] - 1, -1, -1):
        out.append((f"up{i}", 2 * ch[i + 1], h >> (i + 1), w >> (i + 1),
                    i in cfg["attn_layers"]))
    return out


def unet_forward_flops(cfg: dict, h: int, w: int, n: int = 1,
                       emb_rows: int = None) -> float:
    """FLOPs of one forward of n images; `emb_rows` rows of the time
    embedding (n by default; 1 when the step is shared, as in sampling)."""
    emb_rows = n if emb_rows is None else emb_rows
    ch = channel_schedule(cfg)
    td = cfg["time_dim"]

    def conv(cin, cout, k, ho, wo):
        return 2.0 * n * cin * cout * k * k * ho * wo

    f = 4 * 2.0 * emb_rows * td * td                       # time MLP
    f += conv(cfg["in_channel"], ch[0], 3, h, w) + conv(ch[0], ch[0], 3, h, w)
    for name, c, hh, ww, attn in levels(cfg, h, w):
        r = cfg["num_resnet_blocks"]
        f += r * 2 * (conv(c, c, 3, hh, ww) + 2.0 * emb_rows * td * c)
        if attn:
            s = hh * ww
            f += r * n * (2.0 * s * c * 3 * c + 4.0 * s * s * c
                          + 2.0 * s * c * c)
        i = int(name[-1])
        if name.startswith("down"):
            f += conv(c, ch[i + 1], 3, hh // 2, ww // 2)
        else:                     # transposed conv, counted on its input
            f += conv(c, ch[i], 4, hh, ww)
    layers = cfg["num_layers"]
    f += 2 * conv(ch[-1], ch[-1], 3, h >> layers, w >> layers)
    f += conv(ch[0], ch[0], 3, h, w) + conv(ch[0], cfg["out_channel"], 3,
                                            h, w)
    return f


def adagn_work(n, h, w, c, esize) -> Work:
    """GroupNorm + FiLM over (n, h, w, c): x read, out written, the
    per-sample scale and shift and the per-channel affine read.
    Elementwise, so its bound is the bytes."""
    return 0.0, 2.0 * n * h * w * c * esize + 2.0 * n * c * esize + 8.0 * c


def block_work(n, s, c, esize) -> Work:
    """The attention block over (n, s, c), d_k = c: qkv projection, scores,
    probabilities times v, output projection and residual."""
    ops = n * (2.0 * s * c * 3 * c + 4.0 * s * s * c + 2.0 * s * c * c)
    byt = (2.0 * n * s * c * esize + 4.0 * c * c * esize + 4.0 * 4 * c)
    return ops, byt


def attention_backward_work(n, s, d, esize) -> Work:
    """dQ, dK and dV of softmax attention over (n, s, d) from q, k, v, the
    output's gradient and the row statistics: the scores recomputed once
    and four products (dV, dP, dQ, dK)."""
    ops = 10.0 * n * s * s * d
    byt = 4.0 * n * s * d * esize + 2.0 * 4 * n * s + 3.0 * n * s * d * esize
    return ops, byt


def kernel_work(cfg: dict, h: int, w: int, n: int, esize: int,
                whole_s_max: int, backward: bool
                ) -> Dict[str, List[Work]]:
    """{kernel function: [work of each call in one U-Net call]}: every
    AdaGN (`fused_adagn`), every attention block (`fused_attention_block`,
    whole-S or streaming), and with `backward` one streaming attention
    backward (`streaming_dv` with its dK and dQ passes) per block past
    `whole_s_max` tokens."""
    out: Dict[str, List[Work]] = {"fused_adagn": [],
                                  "fused_attention_block": [],
                                  "streaming_dv": []}
    for _, c, hh, ww, attn in levels(cfg, h, w):
        for _ in range(cfg["num_resnet_blocks"]):
            out["fused_adagn"] += [adagn_work(n, hh, ww, c, esize)] * 2
            if attn:
                s = hh * ww
                out["fused_attention_block"].append(
                    block_work(n, s, c, esize))
                if backward and s > whole_s_max:
                    out["streaming_dv"].append(
                        attention_backward_work(n, s, c, esize))
    return {k: v for k, v in out.items() if v}
