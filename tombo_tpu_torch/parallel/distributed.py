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
(:func:`init_distributed`).  At the join they also agree, once and
deterministically, on the route of the merge (:func:`choose_route`):
the device route, an NCCL group over which each host's sums travel on
the card its run uses (:func:`psum_hosts_device`), when every host runs
on a card of its own; else the host route, the gloo group (runs on the
CPU, or two processes sharing one card, which NCCL refuses).  With one host every
helper is an exact no-op, so callers keep one code path.  There is no
fallback: a failed join, group or gather raises.
"""
from __future__ import annotations

import dataclasses
import zlib
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device, resolve_mesh


@dataclass(frozen=True)
class DistContext:
    """Identity of this host within a multi-host run, and the merge route
    the hosts agreed at :func:`init_distributed`: "host" (gloo) or
    "device", with its NCCL group and the run's card."""
    n_hosts: int = 1
    host_id: int = 0
    route: str = "host"
    group: Any = dataclasses.field(default=None, compare=False, repr=False)
    device: Optional[torch.device] = None

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
                     process_id: Optional[int] = None,
                     device: DeviceLike = None) -> DistContext:
    """Join the run's process group (gloo, rendezvous at
    ``coordinator_address``, ``host:port`` or ``tcp://host:port``) and
    return this host's identity.  ``device`` is the run's device (None
    is the card, as for every entry point); only a CUDA device can take
    the device route, so a CPU run touches no card.  With
    ``num_processes`` absent or 1 no group is made and the context is
    the single host's."""
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
    ctx = DistContext(n_hosts=dist.get_world_size(),
                      host_id=dist.get_rank())
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return _establish_route(ctx, dev)


def card_identity(device: torch.device) -> str:
    """The run's card, as the route choice compares cards: the UUID of
    ``device`` when it is a CUDA device, else "none"."""
    if device.type != "cuda":
        return "none"
    return str(torch.cuda.get_device_properties(device).uuid)


def choose_route(identities) -> str:
    """The merge route of a run from every host's :func:`card_identity`,
    in rank order: "device" when every host has a card and no two share
    one, else "host".  A function of the list alone, so every host that
    sees the same list picks the same route."""
    ids = list(identities)
    if "none" not in ids and len(set(ids)) == len(ids):
        return "device"
    return "host"


# the path the last multi-host psum_hosts call took ("host" or "device")
LAST_PSUM_PATH = {"path": None}


def _establish_route(ctx: DistContext, device: torch.device) -> DistContext:
    """Agree on the merge route while the hosts are in step at the join:
    one gloo all-gather of every host's :func:`card_identity` of its
    run's ``device``, the same :func:`choose_route` on every host, and on
    the device route one NCCL group, made by every host together; a
    failure raises (there is no probe and no fallback, so no host can
    take another path than the rest).  Returns ``ctx`` with the route."""
    ids = [None] * ctx.n_hosts
    dist.all_gather_object(ids, card_identity(device))
    if choose_route(ids) == "host":
        return ctx
    return dataclasses.replace(ctx, route="device", device=device,
                               group=dist.new_group(backend="nccl"))


def _gather_sum(arrays, group, device: torch.device):
    """Each array gathered from every rank of ``group`` (None: the
    default group) on ``device`` and the parts summed there in rank
    order: an all-gather, not an all-reduce, whose order NCCL chooses,
    so float totals depend neither on timing nor on the route.  Integer
    arrays go over the wire as int32 (per-host site counts are far below
    2^31) and sum in int64; floats keep their dtype.  Returns numpy
    arrays, the same on every rank."""
    n = dist.get_world_size(group)
    out = []
    for a in arrays:
        a = np.asarray(a)
        int_in = np.issubdtype(a.dtype, np.integer)
        wire = torch.from_numpy(np.ascontiguousarray(
            a.astype(np.int32) if int_in else a)).to(device)
        parts = [torch.empty_like(wire) for _ in range(n)]
        dist.all_gather(parts, wire, group=group)
        total = parts[0].to(torch.int64) if int_in else parts[0].clone()
        for p in parts[1:]:
            total += p
        out.append(total.cpu().numpy())
    return tuple(out)


def psum_hosts_device(ctx: DistContext, *arrays):
    """Element-wise sum of each integer or float32 array over the hosts
    of ``ctx.group``, the device route's NCCL group (else the default
    group), each carried on ``ctx.device`` for an NCCL group and on the
    CPU for a gloo one (:func:`_gather_sum`), so float32 totals are
    bitwise :func:`psum_hosts`'s host path."""
    for a in arrays:
        if not _device_payload(np.asarray(a)):
            raise TypeError("psum_hosts_device: %s payload" %
                            np.asarray(a).dtype)
    if dist.get_backend(ctx.group) != "nccl":
        return _gather_sum(arrays, ctx.group, torch.device("cpu"))
    if ctx.device is None or ctx.device.type != "cuda":
        raise ValueError("psum_hosts_device: an NCCL group needs the run's "
                         "card in ctx.device")
    return _gather_sum(arrays, ctx.group, ctx.device)


def _device_payload(a: np.ndarray) -> bool:
    """Integer and float32 arrays travel on the device route; float64
    ones (group-test statistics) keep the host route, whose sums are
    float64.  A choice by dtype alone, the same on every host."""
    return np.issubdtype(a.dtype, np.integer) or a.dtype == np.float32


def psum_hosts(ctx: DistContext, *arrays):
    """Element-wise sum of each array over all hosts; every host receives
    the same totals, summed in rank order (:func:`_gather_sum`): on the
    device route (:func:`psum_hosts_device`) for integer and float32
    payloads, else over the gloo group on the host.  ``LAST_PSUM_PATH``
    records the path.  With one host the inputs come back unchanged."""
    if ctx.n_hosts <= 1:
        return arrays
    if ctx.route == "device" and all(_device_payload(np.asarray(a))
                                     for a in arrays):
        LAST_PSUM_PATH["path"] = "device"
        return psum_hosts_device(ctx, *arrays)
    LAST_PSUM_PATH["path"] = "host"
    return _gather_sum(arrays, None, torch.device("cpu"))


def psum_collective_dryrun(devices) -> int:
    """One process's run of the cross-device merge (counterpart of
    ``tombo_tpu/parallel/distributed.py::psum_collective_dryrun``): one
    int32 shard of value i + 1 on device i, summed in device order on the
    first, the total copied to every device and checked against
    n (n + 1) / 2 on each.  A device may repeat.  Returns the total."""
    from .mesh import replicate_sum
    mesh = resolve_mesh(devices)
    n, width = len(mesh), 1024
    reps = replicate_sum(mesh, [
        torch.full((width,), i + 1, dtype=torch.int32, device=d)
        for i, d in enumerate(mesh)])
    want = n * (n + 1) // 2
    for d, r in zip(mesh, reps):
        if r.device != d or not bool((r == want).all()):
            raise AssertionError("psum_collective_dryrun: %s on %s, want "
                                 "%d" % (r[:4].tolist(), r.device, want))
    return want
