"""unet_call_ms.serve (ms): device time of every kernel in the trace over
the U-Net calls launched in it."""
from gpubench.layer_math import device_ms_per


def read(record, trace):
    return device_ms_per(trace, "unet_calls")
