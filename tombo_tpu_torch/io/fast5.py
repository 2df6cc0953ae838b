"""FAST5 reads of the detection and estimation paths (subset copy of
``tombo_tpu/io/fast5.py``): a re-squiggled read's corrected-group
``Events``, its raw signal and its read id.

``h5py`` is imported inside the functions that open a file, so the card
path, which reads no FAST5, runs without it."""
from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np

from ..errors import TomboError


def get_read_id(fast5_data) -> str:
    """The read id of an open FAST5 file, from its raw-signal group
    (reference: tombo/tombo_helper.py:2072-2092)."""
    try:
        slot = next(iter(fast5_data["/Raw/Reads"].values()))
    except (KeyError, StopIteration):
        raise TomboError("Raw data is not found in /Raw/Reads/Read_[read#]")
    rid = slot.attrs.get("read_id")
    if rid is None:
        rid = slot.attrs.get("read_num", "unknown")
    if isinstance(rid, bytes):
        rid = rid.decode()
    return str(rid)


def read_corrected_levels(fn: str, corr_group: str,
                          read_id: Optional[str] = None
                          ) -> Tuple[np.ndarray, str, str]:
    """(norm_mean per base, base sequence, read id) of one read's
    corrected group, read-centric (reference: tombo/tombo_helper.py:
    1593-1659).  ``read_id``, when the index carries it, saves the walk of
    /Raw/Reads."""
    import h5py
    with h5py.File(fn, "r") as fp:
        events = fp["/Analyses/" + corr_group]["Events"][:]
        means = events["norm_mean"]
        seq = b"".join(events["base"]).decode()
        if read_id is None:
            try:
                read_id = get_read_id(fp)
            except TomboError:
                read_id = "unknown"
    return means, seq, read_id


def read_raw_and_events(fn: str, corr_group: str
                        ) -> Tuple[np.ndarray, np.ndarray, str]:
    """(stored raw signal, event starts, base sequence) of one read's
    corrected group (reference: tombo/tombo_stats.py:1618-1624)."""
    import h5py
    with h5py.File(fn, "r") as fp:
        try:
            raw = next(iter(fp["/Raw/Reads"].values()))["Signal"][:]
        except (KeyError, StopIteration):
            raise TomboError("Cannot read raw signal data")
        events = fp["/Analyses/" + corr_group + "/Events"]
        starts = events["start"][:].astype(np.int64)
        seq = b"".join(events["base"][:]).decode()
    return raw, starts, seq


def iter_fast5_reads(fast5s_dir: str) -> Iterator[str]:
    """Every .fast5 file under a directory tree, sorted within each
    directory."""
    for root, _, fns in os.walk(fast5s_dir):
        for fn in sorted(fns):
            if fn.endswith(".fast5"):
                yield os.path.join(root, fn)
