"""step_mfu.train (%): images trained in the window times three forwards of
FLOPs (forward and backward, no recompute counted), over the window's
seconds and the bf16 peak of the cards."""
from gpubench.layer_math import mfu


def read(record, trace):
    return mfu(3.0 * record["images"] * record["forward_flops"],
               record["window_s"], record["chips"])
