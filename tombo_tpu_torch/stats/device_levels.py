"""Device-resident per-read event means: re-squiggle feeds detection
(counterpart of ``tombo_tpu/stats/device_levels.py``).

The batched fit of re-squiggle (``pipeline/batch.py`` ``_stage_fit``)
computes every read's rescaled event means on the device.  This cache
keeps those (B, L) mean matrices where they are and hands the detection
packer (``stats/device.py``) row handles instead of host arrays, so a
detection pass in the same process gathers levels on the device and reads
no FAST5 file (reference behaviour replaced: per-test Events re-reads,
tombo/tombo_stats.py:3705,3803,4013).

The means are the fit's own values in its dtype (float32 on the card);
the FAST5 route serves the float64 means that writeback recomputes.  They
agree to float32 rounding, and detection may flip a site at threshold
between the two (``README.md``, "Precision contract").

The cache is per process and keyed by read id within one device type
("cuda" or "cpu"), so a CPU re-run of some reads never replaces their card
entries; a later registration of a read on the same device type wins.  An
entry is served only when the requested span length equals the registered
one, so an index row from another re-squiggle never pairs with another
read's means.  Past ``CAP_BYTES`` the oldest batches go first.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import torch

# bytes of mean matrices held per device type before the oldest batches
# are dropped (the JAX lane's default)
CAP_BYTES = 512 << 20

_lock = threading.Lock()


class _Registry:
    """One device type's batches, oldest first: key -> (tensor, {read_id:
    (offset, n_bases)}), the offset of a read's first mean in the
    flattened tensor; and read_id -> (key, offset, n_bases)."""

    def __init__(self):
        self.batches: "OrderedDict[int, tuple]" = OrderedDict()
        self.by_read: Dict[str, Tuple[int, int, int]] = {}
        self.total_bytes = 0

    def drop_batch(self, key: int):
        arr, _ = self.batches.pop(key)
        self.total_bytes -= arr.numel() * arr.element_size()

    def forget(self, read_id: str):
        hit = self.by_read.pop(read_id, None)
        if hit is not None:
            b = self.batches.get(hit[0])
            if b is not None:
                b[1].pop(read_id, None)
                if not b[1]:
                    self.drop_batch(hit[0])


_registries: Dict[str, _Registry] = {}
_next_key = 0


def register_batch(arr: torch.Tensor,
                   entries: List[Tuple[str, int, int]]) -> None:
    """Keep one re-squiggle batch's mean matrix.

    ``arr``: (B, L) read-centric rescaled event means on the device of the
    fit; ``entries``: (read_id, row, n_bases) of the reads whose results
    the batch returns."""
    global _next_key
    entries = [e for e in entries if e[0]]
    if arr is None or not entries:
        return
    L = arr.shape[1]
    with _lock:
        reg = _registries.setdefault(arr.device.type, _Registry())
        key = _next_key
        _next_key += 1
        for read_id, _, _ in entries:
            reg.forget(read_id)
        reg.batches[key] = (arr, {rid: (row * L, nb)
                                  for rid, row, nb in entries})
        reg.by_read.update((rid, (key, row * L, nb))
                           for rid, row, nb in entries)
        reg.total_bytes += arr.numel() * arr.element_size()
        while reg.total_bytes > CAP_BYTES and len(reg.batches) > 1:
            old_key = next(iter(reg.batches))
            for rid in reg.batches[old_key][1]:
                del reg.by_read[rid]
            reg.drop_batch(old_key)


def _compact_locked(reg: _Registry, device: torch.device) -> None:
    """Concatenate every batch, flattened, into one tensor on ``device``,
    so detection has one gather source a dispatch (no padding: each
    batch keeps its own row width)."""
    if len(reg.batches) == 1:
        arr = next(iter(reg.batches.values()))[0]
        if arr.device == device and arr.dim() == 1:
            return
    parts, entries, off = [], {}, 0
    for arr, rows in reg.batches.values():
        parts.append(arr.reshape(-1).to(device))
        for rid, (o, nb) in rows.items():
            entries[rid] = (off + o, nb)
        off += arr.numel()
    flat = torch.cat(parts)
    reg.batches.clear()
    reg.batches[0] = (flat, entries)
    reg.by_read = {rid: (0, o, nb) for rid, (o, nb) in entries.items()}
    reg.total_bytes = flat.numel() * flat.element_size()


def lookup(read_id: Optional[str], n_bases: int, device: torch.device):
    """(flat tensor, offset of the read's first mean) when ``read_id`` was
    registered on ``device``'s type with exactly ``n_bases`` means, else
    None.  The first lookup after a registration merges the device
    type's batches onto ``device``."""
    if not read_id:
        return None
    with _lock:
        reg = _registries.get(device.type)
        if reg is None or read_id not in reg.by_read:
            return None
        if device.type == "cuda" and device.index is None:
            # "cuda" is the current card: compare as cuda:<index>, or
            # every lookup would merge the batches again
            device = torch.device("cuda", torch.cuda.current_device())
        _compact_locked(reg, device)
        key, off, nb = reg.by_read[read_id]
        if nb != n_bases:
            return None
        return reg.batches[key][0], off


def unregister(read_id: Optional[str], device_type: str) -> None:
    """Drop one read's entry on ``device_type`` (the read failed there,
    or its result came from a host lane, so the cached means are not what
    the batch returned)."""
    if not read_id:
        return
    with _lock:
        reg = _registries.get(device_type)
        if reg is not None:
            reg.forget(read_id)


def clear() -> None:
    with _lock:
        _registries.clear()


def stats() -> dict:
    """{"batches", "reads", "bytes"} summed over device types."""
    with _lock:
        regs = list(_registries.values())
        return {"batches": sum(len(r.batches) for r in regs),
                "reads": sum(len(r.by_read) for r in regs),
                "bytes": sum(r.total_bytes for r in regs)}
