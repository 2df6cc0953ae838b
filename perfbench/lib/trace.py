"""Reading a torch.profiler trace (Chrome trace JSON) of a slice of the
window: the device's busy time as the union of its operations, the
operations that took the most device time, the device's idle time by
the host stage (a ``record_function`` range) that was running, and the
device seconds of named kernels.  The arithmetic of the busy union is a
copy of the repository's card smoke run's ``profile_call``."""
from __future__ import annotations

import json
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_RANGE_CAT = "user_annotation"


class Slice:
    """The parsed trace: ``device`` (start us, end us, name) of every
    device operation, ``ranges`` (start us, end us, name) of every host
    range."""

    def __init__(self, events: List[dict]):
        self.device: List[Tuple[float, float, str]] = []
        self.ranges: List[Tuple[float, float, str]] = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            span = (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    str(e.get("name", "")))
            if e.get("cat") in DEVICE_CATS:
                self.device.append(span)
            elif e.get("cat") == HOST_RANGE_CAT:
                self.ranges.append(span)
        self.device.sort()

    @classmethod
    def load(cls, path: str) -> "Slice":
        with open(path) as f:
            return cls(json.load(f).get("traceEvents", []))

    def busy(self) -> List[Tuple[float, float]]:
        """The union of the device operations, as disjoint intervals."""
        out: List[List[float]] = []
        for s, e, _ in self.device:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) * 1e-6

    def span(self) -> Tuple[float, float]:
        """First and last microsecond of the traced stages (host ranges),
        or of the device operations where there are none."""
        pts = self.ranges or self.device
        return min(s for s, _, _ in pts), max(e for _, e, _ in pts)

    def device_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for s, e, name in self.device:
            by[name] = by.get(name, 0.0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[k[:80], v * 1e-6] for k, v in top]

    def kernel_s(self, needles: Tuple[str, ...]) -> float:
        """Device seconds of the kernels whose name holds one of
        ``needles``."""
        return sum(e - s for s, e, name in self.device
                   if any(k in name for k in needles)) * 1e-6

    def idle_by_stage(self, n: int = 10) -> List[list]:
        """The device's idle time inside the traced span, each part of a
        gap charged to the innermost host range over it."""
        lo, hi = self.span()
        gaps, t = [], lo
        for a, b in self.busy():
            if a > t:
                gaps.append((t, min(a, hi)))
            t = max(t, b)
        if hi > t:
            gaps.append((t, hi))
        ranges = sorted(self.ranges, key=lambda r: r[1] - r[0])
        by: Dict[str, float] = {}
        for a, b in gaps:
            if b <= a:
                continue
            cuts = sorted({a, b} | {x for r in ranges for x in r[:2]
                                    if a < x < b})
            for p, q in zip(cuts[:-1], cuts[1:]):
                mid = 0.5 * (p + q)
                name = next((r[2] for r in ranges if r[0] <= mid <= r[1]),
                            "outside any stage")
                by[name] = by.get(name, 0.0) + (q - p)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[k[:80], v * 1e-6] for k, v in top]
