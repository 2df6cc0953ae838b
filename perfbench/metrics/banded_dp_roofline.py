"""K1, K2 and K2' (`csrc/banded_dp.cu`, `csrc/banded_dp_chunked.cu`):
the least time of the traced slice's DP launches, counted from their
inputs, as a share of those kernels' device time."""
from perfbench.lib.readers import roofline_share
from perfbench.lib.roofline import DP_KERNELS


def read(ctx):
    return roofline_share(ctx, DP_KERNELS, ("dp", "dp_chunked"))
