"""The card, as the host waits for it: every `<stage>_fetch` span of the
stage profile (the host's waits in its device to host copies), summed,
microseconds a read."""


def read(ctx):
    waits = [s for k, s in ctx.timings.items() if k.endswith("_fetch")]
    if not waits or not ctx.reads:
        return None
    return 1e6 * sum(waits) / ctx.reads
