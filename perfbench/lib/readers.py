"""Arithmetic the per-layer metrics' readers share."""
from __future__ import annotations

from typing import Optional

from perfbench.lib import roofline


def us_per_read(ctx, *keys: str) -> Optional[float]:
    """The stage profile's seconds of ``keys`` (summed) in microseconds a
    read of the profiled batches; None where none of them was timed."""
    have = [ctx.timings[k] for k in keys if k in ctx.timings]
    if not have or not ctx.reads:
        return None
    return 1e6 * sum(have) / ctx.reads


def roofline_share(ctx, kernels: tuple, names: tuple) -> Optional[float]:
    """Per cent of the least time of the slice's launches of the wrappers
    ``names`` in the device seconds of the kernels ``kernels``."""
    if ctx.slice is None:
        return None
    work = []
    for w in ctx.launches:
        if w["kernel"] not in names:
            continue
        work.append(roofline.count_le_work(w) if w["kernel"] == "count_le"
                    else roofline.dp_work(w))
    return roofline.share(work, ctx.slice.kernel_s(kernels),
                          ctx.device_name)
