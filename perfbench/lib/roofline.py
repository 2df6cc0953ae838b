"""The yardstick of the kernels: the card's published peaks and the work
each kernel launch needs, counted from the launch's own inputs.

The least time a launch can take is the larger of its operations over
the float32 rate (outside the tensor cores) and its bytes over the memory
rate.  Bytes count each input read once and each output written once,
whatever a kernel reads again or keeps as scratch; operations count the
band cells that the reads' lengths and bands need, once, whatever a
kernel recomputes."""
from __future__ import annotations

from typing import Dict, List

import numpy as np

# NVIDIA H100 SXM data sheet, at the full 700 W power limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "f32_ops_per_s": 67e12},
}
# float32 operations of one band cell of one DP row: the z-score, the
# winsorizing clip, the three moves and their comparisons, the prefix max
DP_OPS_PER_CELL = 20
# the kernels' names in a device trace: K1, K2 and K2' (the banded DP),
# and K5 (the count)
DP_KERNELS = ("banded_dp_kernel", "chunked_fwd_kernel", "chunked_tb_kernel")
COUNT_LE_KERNELS = ("count_le_kernel",)


def peaks(device_name: str) -> dict:
    if device_name not in PEAKS:
        raise KeyError("no published peaks for %r" % device_name)
    return PEAKS[device_name]


def least_seconds(nbytes: float, ops: float, device_name: str) -> float:
    pk = peaks(device_name)
    return max(nbytes / pk["hbm_bytes_per_s"], ops / pk["f32_ops_per_s"])


def dp_work(shapes: dict) -> dict:
    """Bytes and operations of one banded DP launch (K1, or the chunked
    pair K2 + K2' together): ``shapes`` holds B, E (event columns), L
    (rows), bw, the reference level columns R, P (prefix columns) and the
    rows each read needs (``rows``, a list)."""
    B, E, L, bw = shapes["B"], shapes["E"], shapes["L"], shapes["bw"]
    R, P = shapes["R"], shapes["P"]
    cells = sum(min(int(r), L) for r in shapes["rows"]) * bw
    nbytes = (B * E * 4            # event means
              + 4 * B * 4          # n_events, seq_lens, valid start, rows
              + 2 * B * R * 4      # reference means and SDs
              + 2 * B * P * 4      # prefix starts and ends
              + B * (L + 1) * 4    # segment table out
              + 2 * B              # two error flags out
              + B * bw * 4)        # final forward row out
    return {"bytes": nbytes, "ops": cells * DP_OPS_PER_CELL}


def count_le_work(shapes: dict) -> dict:
    """K5: a (B, M) int32 key matrix and (B, P) pivots in, (B, P) counts
    out; one comparison a key and pivot."""
    B, M, P = shapes["B"], shapes["M"], shapes["P"]
    return {"bytes": 4 * B * M + 8 * B * P, "ops": B * M * P}


def share(launches: List[dict], device_s: float, device_name: str):
    """Per cent of the least time of ``launches`` in their kernels'
    device seconds; None where nothing was launched or timed."""
    if not launches or device_s <= 0:
        return None
    least = sum(least_seconds(w["bytes"], w["ops"], device_name)
                for w in launches)
    return 100.0 * least / device_s


def record_dp(args, chunked: bool, lazy: bool = False) -> Dict:
    """The shapes of a DP wrapper call, from its arguments (event_means,
    n_events, ref_means, ref_sds, seq_lens, prefix_starts, ..., params,
    n_rows).  ``lazy``: ``rows`` is left a copy of the device tensor of
    sequence lengths, for the caller to read later without waiting."""
    em, _nev, rm, _rs, sl, ps = args[:6]
    params, n_rows = args[9], int(args[10])
    if not hasattr(sl, "detach"):
        rows = [int(x) for x in np.asarray(sl).tolist()]
    elif lazy:
        rows = sl.detach().clone()
    else:
        rows = [int(x) for x in sl.detach().cpu().tolist()]
    return {"kernel": "dp_chunked" if chunked else "dp",
            "B": int(em.shape[0]), "E": int(em.shape[1]), "L": n_rows,
            "bw": int(params.bandwidth), "R": int(rm.shape[1]),
            "P": int(ps.shape[1]), "rows": rows}


def record_count_le(keys, pivots) -> Dict:
    return {"kernel": "count_le", "B": int(keys.shape[0]),
            "M": int(keys.shape[1]), "P": int(pivots.shape[1])}
