"""K5 (`csrc/count_le.cu`): the least time of the traced slice's count
launches, counted from their inputs, as a share of its device time."""
from perfbench.lib.readers import roofline_share
from perfbench.lib.roofline import COUNT_LE_KERNELS


def read(ctx):
    return roofline_share(ctx, COUNT_LE_KERNELS, ("count_le",))
