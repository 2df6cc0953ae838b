"""The host's part of the deletion fix: the stage profile's
`delfix_plan` and `delfix_apply` seconds, microseconds a read."""
from perfbench.lib.readers import us_per_read


def read(ctx):
    return us_per_read(ctx, "delfix_plan", "delfix_apply")
