"""Reference sequences, in memory or read from a FASTA file (copy of
``tombo_tpu/io/fasta.py``)."""
from __future__ import annotations

import io
from typing import Dict, List, Optional

from ..errors import TomboError


class Fasta:
    def __init__(self, seqs: Dict[str, str]):
        self._index = dict(seqs)

    @classmethod
    def read(cls, fasta_fn: str) -> "Fasta":
        """Every record of a FASTA file, keyed by the first word of its
        header."""
        index: Dict[str, str] = {}
        curr_id, curr_seq = None, []
        with io.open(fasta_fn) as fp:
            for line in fp:
                if line.startswith(">"):
                    if curr_id is not None:
                        index[curr_id] = "".join(curr_seq)
                    curr_seq = []
                    curr_id = line[1:].split()[0]
                else:
                    curr_seq.append(line.strip())
        if curr_id is not None:
            index[curr_id] = "".join(curr_seq)
        return cls(index)

    def write(self, fasta_fn: str, width: int = 80):
        with io.open(fasta_fn, "w") as fp:
            for chrm, seq in self._index.items():
                fp.write(">" + chrm + "\n")
                for i in range(0, len(seq), width):
                    fp.write(seq[i:i + width] + "\n")

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
