"""conv_ms.serve (ms): cuDNN convolution kernels' device time per U-Net
call in the trace."""
from gpubench.layer_math import conv_ms_per


def read(record, trace):
    return conv_ms_per(trace, "unet_calls")
