"""conv_ms.train (ms): cuDNN convolution kernels' device time per optimizer
step in the trace."""
from gpubench.layer_math import conv_ms_per


def read(record, trace):
    return conv_ms_per(trace, "steps")
