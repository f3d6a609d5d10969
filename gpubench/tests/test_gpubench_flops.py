"""flops.py's count against torch.utils.flop_counter on the program's
plain U-Net (on the meta device: shapes only, no arithmetic)."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from gpubench import flops, harness
from gpubench.peaks import least_seconds

FLAGSHIP = harness.load_json(harness.HERE, "configs", "flagship128.json")
SR = harness.load_json(harness.HERE, "configs", "sr256.json")
SMALL = dict(FLAGSHIP, min_channel=32, max_channel=64, num_layers=3,
             attn_layers=[1, 2], time_dim=32)


def counted(cfg, size, n):
    from sdm_tpu_torch.models import UNet
    with torch.device("meta"):
        net = UNet(**harness.unet_kwargs(cfg), use_kernels=False)
    x = torch.zeros(n, size, size, cfg["in_channel"], device="meta")
    t = torch.zeros(n, dtype=torch.long, device="meta")
    with FlopCounterMode(display=False) as fc:
        net(x, t)
    return fc.get_total_flops()


@pytest.mark.parametrize("cfg,size,n", [(SMALL, 16, 2), (SMALL, 32, 1),
                                        (FLAGSHIP, 128, 2), (SR, 256, 1)])
def test_forward_count_matches_flop_counter(cfg, size, n):
    assert flops.unet_forward_flops(cfg, size, size, n) == counted(cfg, size,
                                                                   n)


def test_full_size_counts():
    assert round(flops.unet_forward_flops(FLAGSHIP, 128, 128) / 1e9, 1) \
        == 168.1
    assert round(flops.unet_forward_flops(SR, 256, 256) / 1e9, 1) == 703.7


def test_kernel_work_per_call():
    work = flops.kernel_work(SR, 256, 256, 16, 2, flops.WHOLE_S_MAX,
                             backward=True)
    assert len(work["fused_adagn"]) == 16
    assert len(work["fused_attention_block"]) == 4
    assert len(work["streaming_dv"]) == 1       # the S = 4096 block only
    fwd = flops.kernel_work(FLAGSHIP, 128, 128, 32, 2, flops.WHOLE_S_MAX,
                            backward=False)
    assert "streaming_dv" not in fwd
    # AdaGN is bound by its bytes, a whole-S block by its operations.
    ops, byt = fwd["fused_adagn"][0]
    assert least_seconds(ops, byt) == byt / 3.35e12
    ops, byt = fwd["fused_attention_block"][0]
    assert least_seconds(ops, byt) == ops / 989e12
