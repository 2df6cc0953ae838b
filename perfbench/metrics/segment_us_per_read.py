"""Stage A (`_segment_batch`, `_upload_raw`, `_start_discovery`): the
stage profile's `segment` and `start` seconds, microseconds a read."""
from perfbench.lib.readers import us_per_read


def read(ctx):
    return us_per_read(ctx, "segment", "start")
