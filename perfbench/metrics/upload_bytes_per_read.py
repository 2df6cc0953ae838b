"""Stage A's raw upload: bytes sent from host to card a read (the
stage profile's `upload` count, which repeats exactly)."""


def read(ctx):
    if not ctx.reads or "upload" not in ctx.transfer_bytes:
        return None
    return ctx.transfer_bytes["upload"] / ctx.reads
