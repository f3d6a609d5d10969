"""kernels_roofline.train (%): as kernels_roofline.serve, with the streaming
attention backward (its dV, dK and dQ passes) counted per streaming_dv
call."""
from gpubench.layer_math import kernels_roofline


def read(record, trace):
    return kernels_roofline(record, trace)
