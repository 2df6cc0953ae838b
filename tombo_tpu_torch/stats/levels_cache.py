"""Columnar per-read levels sidecar: detection without FAST5 re-reads
(copy of ``tombo_tpu/stats/levels_cache.py``; same file format, so each
package reads the other's sidecars).

Detection reads, per read, (norm_mean levels, base sequence, read id).
This module keeps exactly that in one append-log file per FAST5 directory
and corrected group (``.<dir>.<group>.tombo.levels``), so a second
detection pass over the same re-squiggled reads opens no HDF5 file
(reference behaviour replaced: tombo/tombo_helper.py:1593-1659, per
region per run).

* Records carry a length prefix and the source FAST5's (mtime_ns, size),
  checked at lookup, so a re-squiggled read is never served stale (the
  scanner keeps the last record per key).
* Readers index record offsets in one sequential scan and seek records on
  demand; a truncated tail (a crashed writer) is ignored, and the next
  builder truncates back to the last complete record.
* Records are appended by the re-squiggle writeback (``.w<i>`` shards,
  one a writer) and during a detection pass's cache misses, inside a
  ``building()`` block (the data is in memory then).  ``building(False)``
  neither reads nor writes a sidecar during its block (the command
  line's ``--skip-levels-cache``); ``building(write=False)`` reads and
  never writes (a multi-host detection run, whose hosts may share the
  directory).
"""
from __future__ import annotations

import io
import os
import struct
import threading
from typing import Dict, Optional, Tuple

import numpy as np

MAGIC = b"TTLC1\n"
_HDR = struct.Struct("<I")          # record length (bytes after field)
_META = struct.Struct("<HHHQQI")    # fnlen, gplen, idlen, mtime, size, n


def cache_fn(dirpath: str, corr_group: str) -> str:
    base = os.path.basename(os.path.abspath(dirpath))
    return os.path.join(dirpath, ".%s.%s.tombo.levels"
                        % (base, corr_group.replace("/", ".")))


def shard_paths(path: str):
    """The sidecar file plus any writer-shard siblings (``.w<i>`` files
    appended by the resquiggle writeback processes — each process owns
    one shard so no two writers ever share a file)."""
    import glob
    out = []
    if os.path.exists(path):
        out.append(path)
    out.extend(sorted(glob.glob(path + ".w*")))
    return out


def _pack_record(fn_base: str, group: str, read_id: str, mtime_ns: int,
                 size: int, means: np.ndarray, seq: str) -> bytes:
    fn_b = fn_base.encode()
    gp_b = group.encode()
    id_b = (read_id or "").encode()
    means = np.ascontiguousarray(means, np.float64)
    seq_b = seq.encode()
    body = (_META.pack(len(fn_b), len(gp_b), len(id_b),
                       mtime_ns, size, means.shape[0])
            + fn_b + gp_b + id_b + means.tobytes()
            + struct.pack("<I", len(seq_b)) + seq_b)
    return _HDR.pack(len(body)) + body


def _scan(path: str):
    """Yield (key, offset, mtime_ns, size) for each complete record and
    finally the end-of-valid-data offset (stops at a truncated tail)."""
    with open(path, "rb") as fp:
        if fp.read(len(MAGIC)) != MAGIC:
            return
        file_size = os.fstat(fp.fileno()).st_size
        off = len(MAGIC)
        while off + _HDR.size <= file_size:
            (blen,) = _HDR.unpack(fp.read(_HDR.size))
            if off + _HDR.size + blen > file_size:
                break                      # truncated tail
            meta = fp.read(_META.size)
            fnlen, gplen, idlen, mtime_ns, size, _n = _META.unpack(meta)
            names = fp.read(fnlen + gplen)
            key = (names[:fnlen].decode(), names[fnlen:].decode())
            yield key, off, mtime_ns, size
            off += _HDR.size + blen
            fp.seek(off)
        yield None, off, 0, 0


class LevelsCache:
    """Offset-indexed reader over a sidecar file and its writer shards.

    A record's key may appear in several files (e.g. a re-resquiggle
    appended a fresh shard record); all candidates are indexed and the
    (mtime_ns, size) staleness check picks the live one."""

    def __init__(self, path: str):
        self.path = path
        self.paths = shard_paths(path) or [path]
        # key -> list of (file_idx, offset, mtime_ns, size)
        self._idx: Dict[Tuple[str, str], list] = {}
        self.valid_end = len(MAGIC)
        self._fps = []
        for fi, p in enumerate(self.paths):
            if not os.path.exists(p):
                self._fps.append(None)
                continue
            for key, off, mtime_ns, size in _scan(p):
                if key is None:
                    if p == path:
                        self.valid_end = off
                else:
                    self._idx.setdefault(key, []).append(
                        (fi, off, mtime_ns, size))
            self._fps.append(open(p, "rb"))
        self._lock = threading.Lock()

    def __len__(self):
        return len(self._idx)

    def get(self, fn: str, group: str, mtime_ns: int, size: int
            ) -> Optional[Tuple[np.ndarray, str, str]]:
        """(means, seq, read_id) if a record matches the source FAST5's
        current (mtime_ns, size); None on miss or stale entry."""
        ents = self._idx.get((os.path.basename(fn), group))
        if ents is None:
            return None
        hit = next(((fi, off) for fi, off, mt, sz in reversed(ents)
                    if (mt, sz) == (mtime_ns, size)), None)
        if hit is None:
            return None
        fi, off = hit
        fp = self._fps[fi]
        with self._lock:
            fp.seek(off + _HDR.size)
            meta = fp.read(_META.size)
            fnlen, gplen, idlen, _mt, _sz, n = _META.unpack(meta)
            fp.seek(fnlen + gplen, io.SEEK_CUR)
            read_id = fp.read(idlen).decode()
            means = np.frombuffer(fp.read(8 * n), np.float64)
            (slen,) = struct.unpack("<I", fp.read(4))
            seq = fp.read(slen).decode()
        return means, seq, read_id

    def close(self):
        for fp in self._fps:
            if fp is not None:
                fp.close()


class LevelsCacheBuilder:
    """Append-mode writer; truncates a crashed writer's partial tail
    before appending and fsyncs on finalize."""

    def __init__(self, path: str):
        self.path = path
        if os.path.exists(path):
            reader = LevelsCache(path)
            have, end = set(reader._idx), reader.valid_end
            reader.close()
            self._have = have
            self._fp = open(path, "r+b")
            self._fp.truncate(end)
            self._fp.seek(end)
        else:
            self._have = set()
            self._fp = open(path, "wb")
            self._fp.write(MAGIC)
        self._lock = threading.Lock()

    def add(self, fn: str, group: str, read_id: str, mtime_ns: int,
            size: int, means: np.ndarray, seq: str, replace: bool = False):
        """Append one record unless its key is already present.
        ``replace`` (re-squiggle writeback: the FAST5 was just rewritten)
        appends all the same: the scanner keeps the last record of a key,
        and the staleness check retires the old one."""
        key = (os.path.basename(fn), group)
        rec = _pack_record(key[0], group, read_id, mtime_ns, size,
                           means, seq)
        with self._lock:
            if key in self._have and not replace:
                return
            self._have.add(key)
            self._fp.write(rec)

    def flush(self):
        with self._lock:
            self._fp.flush()

    def finalize(self):
        with self._lock:
            self._fp.flush()
            os.fsync(self._fp.fileno())
            self._fp.close()


# ------------------------------------------------------------------ hooks
# process-global registries keyed by (fast5 dir, corr group); the single
# load chokepoint (stats.region.load_read_levels) consults these.

_readers: Dict[Tuple[str, str], Optional[LevelsCache]] = {}
_builders: Dict[Tuple[str, str], Optional[LevelsCacheBuilder]] = {}
_reg_lock = threading.Lock()
_building_active = False
_skip_active = False


def lookup(fn: str, corr_group: str, mtime_ns: int, size: int):
    """Serve one read's (means, seq, read_id) from the directory's
    sidecar, or None (missing or stale, or inside ``building(False)``)."""
    if _skip_active:
        return None
    dirpath = os.path.dirname(fn) or "."
    key = (dirpath, corr_group)
    with _reg_lock:
        rd = _readers.get(key, False)
        if rd is False:
            path = cache_fn(dirpath, corr_group)
            try:
                rd = LevelsCache(path) if shard_paths(path) else None
            except (OSError, struct.error):
                rd = None
            _readers[key] = rd
    if rd is None:
        return None
    return rd.get(fn, corr_group, mtime_ns, size)


def record(fn: str, corr_group: str, read_id: str, mtime_ns: int,
           size: int, means: np.ndarray, seq: str):
    """Opportunistically append a loaded read to the sidecar (no-op
    unless a building() context is active)."""
    if not _building_active:
        return
    dirpath = os.path.dirname(fn) or "."
    key = (dirpath, corr_group)
    with _reg_lock:
        b = _builders.get(key, False)
        if b is False:
            try:
                b = LevelsCacheBuilder(cache_fn(dirpath, corr_group))
            except OSError:
                b = None                  # unwritable dir: skip quietly
            _builders[key] = b
    if b is not None:
        b.add(fn, corr_group, read_id, mtime_ns, size, means, seq)


class building:
    """Context manager around a detection pass: cache misses append to
    the sidecars, finalized (fsync + registry reset) on exit.  With
    ``use_sidecar`` false no sidecar is read or written in the block;
    with ``write`` false sidecars are read and nothing is appended."""

    def __init__(self, use_sidecar: bool = True, write: bool = True):
        self.use_sidecar = use_sidecar
        self.write = write

    def __enter__(self):
        global _building_active, _skip_active
        _building_active = self.use_sidecar and self.write
        _skip_active = not self.use_sidecar
        return self

    def __exit__(self, *exc):
        global _building_active, _skip_active
        _building_active = _skip_active = False
        with _reg_lock:
            builders, readers = dict(_builders), dict(_readers)
            _builders.clear()
            _readers.clear()
        for b in builders.values():
            if b is not None:
                b.finalize()
        for r in readers.values():
            if r is not None:
                r.close()
        return False
