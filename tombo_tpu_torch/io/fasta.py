"""In-memory reference sequences (subset copy of ``tombo_tpu/io/fasta.py``)."""
from __future__ import annotations

from typing import Dict, List, Optional

from ..errors import TomboError


class Fasta:
    def __init__(self, seqs: Dict[str, str]):
        self._index = dict(seqs)

    def get_seq(self, chrm: str, start: Optional[int] = None,
                end: Optional[int] = None, error_end: bool = True) -> str:
        """0-based, end-exclusive sequence extraction."""
        try:
            seq = self._index[chrm]
        except KeyError:
            raise TomboError("Sequence record not found: " + chrm)
        if start is None and end is None:
            return seq
        start = max(0, start or 0)
        if error_end and end is not None and end > len(seq):
            raise TomboError("Sequence position past end of record: " + chrm)
        return seq[start:end]

    def iter_chrms(self) -> List[str]:
        return list(self._index)
