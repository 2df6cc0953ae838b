"""The adaptive DP with the device deletion fix and fit
(`_adaptive_device_call`, `_stage_delfix_fit`): the stage profile's
`adaptive` seconds, microseconds a read."""
from perfbench.lib.readers import us_per_read


def read(ctx):
    return us_per_read(ctx, "adaptive")
