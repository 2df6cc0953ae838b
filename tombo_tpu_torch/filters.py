"""Read filters of the index (subset copy of ``tombo_tpu/filters.py``):
the parser of ``--obs-per-base-filter``, which the re-squiggle runner
applies as it builds the index."""
from __future__ import annotations

from typing import List, Sequence, Tuple

from .errors import TomboError


def parse_obs_filter(obs_filter: Sequence[str]) -> List[Tuple[int, int]]:
    """``pctl:thresh`` pairs: a read is filtered when the given percentile
    of its observations per base exceeds the threshold (reference:
    tombo/tombo_helper.py ``parse_obs_filter``)."""
    if not obs_filter:
        return []
    try:
        return [(int(p), int(t)) for p, t in
                (of.split(":") for of in obs_filter)]
    except Exception:
        raise TomboError("Invalid format for observation filter")
