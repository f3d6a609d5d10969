"""unet_mfu.serve (%): images delivered in the window times the U-Net calls
of each image's chain times the forward FLOPs of one image, over the
window's seconds and the card's bf16 peak."""
from gpubench.layer_math import mfu


def read(record, trace):
    return mfu(record["images"] * record["calls_per_chain"]
               * record["forward_flops"], record["window_s"])
