"""kernels_roofline.serve (%): least time of the work of the port's kernel
functions over their device time in the trace
(layer_math.kernels_roofline)."""
from gpubench.layer_math import kernels_roofline


def read(record, trace):
    return kernels_roofline(record, trace)
