"""BED files of per-site locations (copy of
``tombo_tpu/plot/accuracy.py:23`` ``parse_locs_file``; reference:
tombo/tombo_helper.py:729-753)."""
from __future__ import annotations

import io
from collections import defaultdict
from typing import Dict, Tuple

import numpy as np

from ..errors import TomboError


def parse_locs_file(locs_fn: str) -> Dict[Tuple[str, str], np.ndarray]:
    """(chrm, strand) -> sorted 0-based positions of a 6-field BED file
    (the ``valid_poss`` of motif model estimation)."""
    raw_locs = defaultdict(list)
    with io.open(locs_fn) as fp:
        for line in fp:
            fields = line.rstrip().split("\t")
            if len(fields) < 6:
                raise TomboError(
                    "Loci BED records must contain 6 fields: " + locs_fn)
            chrm, pos, strand = fields[0], int(fields[1]), fields[5]
            raw_locs[(chrm, strand)].append(pos)
    return dict((cs, np.array(sorted(poss)))
                for cs, poss in raw_locs.items())
