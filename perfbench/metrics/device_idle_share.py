"""The card: the share of the traced slice's wall time in which no
operation ran on it (one less the union of its operations over the
slice's length)."""


def read(ctx):
    if ctx.slice is None or not ctx.slice.device or ctx.slice_wall_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.slice.busy_s() / ctx.slice_wall_s)
