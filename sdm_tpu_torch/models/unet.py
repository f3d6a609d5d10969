"""Conditional diffusion U-Net (port of sdm_tpu/models/unet.py, torch.nn).

Topology as the reference U_Net.py: channel schedule from min_channel
doubling per layer and clamped to max_channel; two plain conv blocks in; a
DOWN UNetBlock per layer (attention on `attn_layers`), each output kept as a
skip; two plain conv blocks in the middle; UP UNetBlocks consuming
channel-concatenated skips; conv+Swish, conv, optional tanh out.

`remat` (config "remat") checkpoints each UNetBlock, each of its
sublayers (nested), and each two-conv in, middle and out stack as one unit,
as sdm_tpu's UNet(remat=True) does: the backward re-runs those forwards
(kernels included) instead of holding their activations. Parameter names
do not change, so checkpoints load with or without it.

`forward(x, t, cond)` takes and returns NHWC, as sdm_tpu does; inside, the
activations are NCHW in channels_last memory (see models/layers.py).
Under spatial partitioning (parallel/sp.py) it takes and returns a slab.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from sdm_tpu_torch.enums import UNetBlockType
from sdm_tpu_torch.models.layers import (ConditionalEmbedding, UNetBlock,
                                         UNetConvBlock, remat_call)
from sdm_tpu_torch.parallel import sp


class UNet(nn.Module):
    """Denoiser U-Net. Constructor surface mirrors sdm_tpu's UNet
    (`use_pallas` becomes `use_kernels`)."""

    def __init__(self, num_resnet_blocks: int = 5, in_channel: int = 3,
                 out_channel: int = 3, time_dim: Optional[int] = 64,
                 cond_dim: Optional[int] = None, num_layers: int = 5,
                 attn_layers: Sequence[int] = (2, 3, 4), num_heads: int = 1,
                 dim_per_head: Optional[int] = None, groups: int = 32,
                 min_channel: int = 128, max_channel: int = 512,
                 image_recon: bool = False, parity: bool = True,
                 use_kernels: bool = True, dtype=None, remat: bool = False):
        super().__init__()
        # Validation as U_Net.py:29-38 (sdm_tpu unet.py:72-84).
        if not isinstance(num_layers, int) or not isinstance(
                attn_layers, (list, tuple)):
            raise TypeError("Invalid type!")
        if num_layers < 1:
            raise ValueError("Invalid num layer value!")
        for attn_layer in attn_layers:
            if not isinstance(attn_layer, int):
                raise ValueError("Invalid type in attention layer!")
            if attn_layer < 0 or attn_layer >= num_layers:
                raise ValueError("Invalid Attention Layer values!")
        self.num_layers = num_layers
        self.min_channel, self.max_channel = min_channel, max_channel
        self.image_recon = image_recon
        self.dtype = dtype
        self.remat = remat

        ch = self.channel_schedule()
        emb_dim = time_dim
        common = dict(groups=groups, parity=parity, use_kernels=use_kernels,
                      dtype=dtype)
        plain = dict(common, emb_dim=None)
        block = dict(common, num_resnet_blocks=num_resnet_blocks,
                     num_heads=num_heads, dim_per_head=dim_per_head,
                     emb_dim=emb_dim, remat=remat)
        self.cond_emb = (ConditionalEmbedding(time_dim, cond_dim, dtype)
                         if time_dim is not None else None)
        self.in_layer = nn.ModuleList([
            UNetConvBlock(in_channel, ch[0], True, **plain),
            UNetConvBlock(ch[0], ch[0], True, **plain)])
        self.down_layers = nn.ModuleList([
            UNetBlock(ch[i], ch[i + 1], use_attn=i in attn_layers,
                      block_type=UNetBlockType.DOWN, **block)
            for i in range(num_layers)])
        self.middle_layer = nn.ModuleList([
            UNetConvBlock(ch[-1], ch[-1], True, **plain),
            UNetConvBlock(ch[-1], ch[-1], True, **plain)])
        self.up_layers = nn.ModuleList([
            UNetBlock(2 * ch[i + 1], ch[i], use_attn=i in attn_layers,
                      block_type=UNetBlockType.UP, **block)
            for i in range(num_layers - 1, -1, -1)])
        self.out_layers = nn.ModuleList([
            UNetConvBlock(ch[0], ch[0], True, **plain),
            UNetConvBlock(ch[0], out_channel, False, **plain)])

    def channel_schedule(self) -> list:
        channel_layers = [self.min_channel]
        channel = self.min_channel
        for _ in range(self.num_layers):
            channel = channel * 2
            channel_layers.append(min(channel, self.max_channel))
        return channel_layers

    def forward(self, x: torch.Tensor, t: Optional[torch.Tensor] = None,
                cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (N, H, W, C_in) -> (N, H, W, C_out); t (N,) or (1,) steps.
        Inside sp.spatial(shard), x and the output are this rank's H slab
        of the image."""
        shard = sp.active()
        if shard is not None:
            sp.check_levels(x.shape[1] * shard.size, self.num_layers,
                            shard.size)
        x = x.permute(0, 3, 1, 2)
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        emb = self.cond_emb(t, cond) if self.cond_emb is not None else None

        x = self._stack(self.in_layer, x)
        skips = []
        for layer in self.down_layers:
            x = remat_call(layer, x, emb, remat=self.remat)
            skips.append(x)
        x = self._stack(self.middle_layer, x)
        for layer in self.up_layers:
            x = torch.cat([x, skips.pop()], dim=1)
            x = remat_call(layer, x, emb, remat=self.remat)
        x = self._stack(self.out_layers, x)
        if self.image_recon:
            x = torch.tanh(x)
        return x.permute(0, 2, 3, 1)

    def _stack(self, layers: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
        """A two-conv stack; under remat one checkpoint, so only the
        stack's input is kept (a checkpoint per conv would keep the
        full-resolution tensor between them too)."""
        def run(h):
            for layer in layers:
                h = layer(h)
            return h
        return remat_call(run, x, remat=self.remat)

    @classmethod
    def from_config(cls, config: dict, **overrides) -> "UNet":
        """Build from a training config or bundle model dict (keys per
        create_diffusion_config.py / export_models.py)."""
        recon = config.get("img_recon", config.get("image_recon", False))
        kwargs = dict(
            in_channel=config["in_channel"],
            out_channel=config["out_channel"],
            num_layers=config["num_layers"],
            num_resnet_blocks=config["num_resnet_block"],
            attn_layers=tuple(config["attn_layers"]),
            num_heads=config["attn_heads"],
            dim_per_head=config["attn_dim_per_head"],
            time_dim=config["time_dim"],
            cond_dim=config["cond_dim"],
            min_channel=config["min_channel"],
            max_channel=config["max_channel"],
            image_recon=recon,
            remat=bool(config.get("remat", False)),
        )
        kwargs.update(overrides)
        return cls(**kwargs)
