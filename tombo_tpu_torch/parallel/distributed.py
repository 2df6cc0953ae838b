"""Reads divided among hosts, and their per-site sums merged (counterpart of
``tombo_tpu/parallel/distributed.py``).

The reference scales only across the processes of one node
(tombo/resquiggle.py:1859-1948, tombo/tombo_stats.py:4400-4608).  Across
hosts, each host owns a fixed set of reads (:func:`read_shard`, a stable
hash of the read identity, so every host knows the whole assignment
without talking), re-squiggles them and computes dense per-site sums over
them; :func:`psum_hosts` then adds those sums over all hosts, so every
host ends with the same totals whatever the host count.

The hosts meet in a ``torch.distributed`` process group over gloo
(:func:`init_distributed`).  With one host every helper is an exact
no-op, so callers keep one code path.  There is no fallback: a failed
join or a failed gather raises.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


@dataclass(frozen=True)
class DistContext:
    """Identity of this host within a multi-host run."""
    n_hosts: int = 1
    host_id: int = 0

    @property
    def is_main(self) -> bool:
        return self.host_id == 0

    def owns_read(self, read_key: str) -> bool:
        return read_shard(read_key, self.n_hosts) == self.host_id

    def owns_region(self, region_index: int) -> bool:
        """Deterministic region -> host assignment (level and group
        statistics need every read of a site on one host)."""
        return region_index % self.n_hosts == self.host_id


def read_shard(read_key: str, n_hosts: int) -> int:
    """Host index of a read: CRC32 of its identity modulo the host count,
    stable across runs, processes and platforms."""
    if n_hosts <= 1:
        return 0
    return zlib.crc32(read_key.encode("utf-8")) % n_hosts


def read_key(r_data) -> str:
    """Sharding key of an index record: the read id when present, else
    the (file name, mapped start) pair, which is as stable."""
    if getattr(r_data, "read_id", None):
        return r_data.read_id
    return "%s:%d" % (getattr(r_data, "fn", ""), getattr(r_data, "start", 0))


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> DistContext:
    """Join the run's process group (gloo, rendezvous at
    ``coordinator_address``, ``host:port`` or ``tcp://host:port``) and
    return this host's identity.  With ``num_processes`` absent or 1 no
    group is made and the context is the single host's."""
    if num_processes in (None, 1):
        return DistContext()
    if coordinator_address is None or process_id is None:
        raise ValueError("a multi-host run needs coordinator_address and "
                         "process_id")
    if "://" not in coordinator_address:
        coordinator_address = "tcp://" + coordinator_address
    dist.init_process_group(
        "gloo", init_method=coordinator_address, world_size=num_processes,
        rank=process_id)
    return DistContext(n_hosts=dist.get_world_size(),
                       host_id=dist.get_rank())


def psum_hosts(ctx: DistContext, *arrays):
    """Element-wise sum of each array over all hosts; every host receives
    the same totals.  Each array is gathered from every host in rank
    order and summed in that order, so float totals do not depend on
    timing.  Integer arrays go over the wire as int32 (per-host site
    counts are far below 2^31) and are summed in int64.  With one host
    the inputs come back unchanged."""
    if ctx.n_hosts <= 1:
        return arrays
    out = []
    for a in arrays:
        a = np.asarray(a)
        int_in = np.issubdtype(a.dtype, np.integer)
        wire = torch.from_numpy(np.ascontiguousarray(
            a.astype(np.int32) if int_in else a))
        parts = [torch.empty_like(wire) for _ in range(ctx.n_hosts)]
        dist.all_gather(parts, wire)
        total = parts[0].numpy().astype(np.int64 if int_in else a.dtype)
        for p in parts[1:]:
            total += p.numpy()
        out.append(total)
    return tuple(out)
