"""Finalize (`_finalize`, `_finalize_native`): the stage profile's
`finalize` seconds (`finalize_native` within them), microseconds a read."""
from perfbench.lib.readers import us_per_read


def read(ctx):
    return us_per_read(ctx, "finalize")
