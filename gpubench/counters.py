"""The counts a traced window reads: the port's launch counters of its
kernel functions, and the benchmark's own counts of U-Net calls (a forward
pre-hook on the program's U-Net) and of optimizer steps."""

from __future__ import annotations

from typing import Dict

# The port's kernel functions whose calls `flops.kernel_work` counts.
KERNEL_FUNCTIONS = ("fused_adagn", "fused_attention_block", "streaming_dv")


class Counts:
    def __init__(self):
        self.own = {"unet_calls": 0, "steps": 0}

    def watch(self, net) -> None:
        """Count every forward call of `net`."""
        def hook(module, args):
            self.own["unet_calls"] += 1
        net.register_forward_pre_hook(hook)

    def read(self) -> Dict[str, int]:
        from sdm_tpu_torch.kernels.adagn import fused_adagn
        from sdm_tpu_torch.kernels.attention_block import \
            fused_attention_block
        from sdm_tpu_torch.kernels.streaming_attention import streaming_dv
        out = dict(self.own)
        for fn in (fused_adagn, fused_attention_block, streaming_dv):
            out[fn.__name__] = fn.launches
        return out
