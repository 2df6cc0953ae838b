"""Batch planning (`_plan_reads`, `_kmer_plan`): the stage profile's
`plan` seconds, microseconds a read."""
from perfbench.lib.readers import us_per_read


def read(ctx):
    return us_per_read(ctx, "plan")
