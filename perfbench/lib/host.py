"""What the host was doing during the window, so that a slow stretch
shows beside the numbers it slowed: the machine's CPU time stolen by the
hypervisor and its busy share (``/proc/stat``, where its counters move),
the cores' clock (``/proc/cpuinfo``), the cores this process kept busy
(its threads' CPU time over the wall time), and the time one core takes
for a fixed piece of Python work just before and just after the window
(``probe_ms``), which reads how fast the host runs whatever the
machine reports of itself."""
from __future__ import annotations

import os
import time
from typing import List, Optional


def _stat() -> Optional[List[int]]:
    """user, nice, system, idle, iowait, irq, softirq, steal (ticks)."""
    try:
        with open("/proc/stat") as f:
            head = f.readline().split()
    except OSError:
        return None
    if not head or head[0] != "cpu":
        return None
    vals = [int(x) for x in head[1:9]]
    return vals + [0] * (8 - len(vals))


def _mhz() -> Optional[float]:
    try:
        with open("/proc/cpuinfo") as f:
            mhz = [float(line.split(":")[1]) for line in f
                   if line.startswith("cpu MHz")]
    except (OSError, ValueError, IndexError):
        return None
    return sum(mhz) / len(mhz) if mhz else None


def probe_ms() -> float:
    """Milliseconds for a fixed loop of Python arithmetic (~30 ms)."""
    t = time.perf_counter()
    x = 0
    for i in range(300000):
        x += i * i % 7
    return (time.perf_counter() - t) * 1e3


class Watch:
    """``Watch()`` at the window's start, ``read()`` at its end."""

    def __init__(self):
        self.probe0 = probe_ms()
        self.t0 = time.perf_counter()
        self.stat0 = _stat()
        self.mhz0 = _mhz()
        t = os.times()
        self.cpu0 = t.user + t.system

    def read(self) -> dict:
        wall = time.perf_counter() - self.t0
        t = os.times()
        stat1 = _stat()
        out = {"own_cores": (t.user + t.system - self.cpu0) / wall,
               "cpu_mhz": [self.mhz0, _mhz()], "ncpu": os.cpu_count(),
               "probe_ms": [self.probe0, probe_ms()]}
        if self.stat0 is None or stat1 is None:
            out["proc_stat"] = "unread"
            return out
        d = [b - a for a, b in zip(self.stat0, stat1)]
        total = sum(d)
        if total <= 0:
            out["proc_stat"] = "static"
        else:
            out["steal_share"] = d[7] / total
            out["busy_share"] = (total - d[3] - d[4]) / total
        return out
