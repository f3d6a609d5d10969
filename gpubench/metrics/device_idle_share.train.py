"""device_idle_share.train (%): share of the traced window with no kernel
running."""
from gpubench.layer_math import idle_share


def read(record, trace):
    return idle_share(trace)
