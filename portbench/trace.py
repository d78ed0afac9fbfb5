"""The device trace of a traced run, reduced to what the per-layer readers
and the result line need: the busy time as the union of the device's
operation intervals over the traced window, the idle gaps named by what the
host was doing, device time by operation name, and device time of the
operations launched inside a named host range.

The window is the host range `portbench.window` that the harness records
around the traced units (it ends after a synchronise), on the profiler's
own clock, which the device events share.
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

WINDOW = "portbench.window"


def union_length(intervals: List[Tuple[int, int]], lo: int, hi: int) -> int:
    """The length of the union of [start, end) intervals clipped to [lo, hi)."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: List[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The stretches of [lo, hi) that no interval covers."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if e <= at:
            continue
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


@dataclass
class Trace:
    """Device and host events of one traced window (times in ns)."""

    lo: int
    hi: int
    device: List[Tuple[str, int, int, int]] = field(default_factory=list)  # name, s, e, corr
    host: List[Tuple[str, int, int, int]] = field(default_factory=list)  # name, s, e, corr

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e9

    @property
    def busy_s(self) -> float:
        return union_length([(s, e) for _, s, e, _ in self.device], self.lo, self.hi) / 1e9

    def kernels(self, pattern: str) -> Tuple[int, float]:
        """(launches, device seconds) of the operations whose name matches."""
        rx = re.compile(pattern)
        hits = [(e - s) for name, s, e, _ in self.device if rx.search(name)]
        return len(hits), sum(hits) / 1e9

    def by_name(self, top: int = 10) -> List[List]:
        """[[name, device seconds]] of the operations that took most time."""
        acc: Dict[str, int] = {}
        for name, s, e, _ in self.device:
            key = short_name(name)
            acc[key] = acc.get(key, 0) + (e - s)
        return [[k, v / 1e9] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """[[what the host was doing, idle device seconds]]: each idle gap of
        the window is named by the innermost host range running at its
        middle, the totals by name, largest first."""
        host = sorted(((s, e, name) for name, s, e, _ in self.host if name != WINDOW),
                      key=lambda t: t[0])
        starts = [h[0] for h in host]
        acc: Dict[str, int] = {}
        for s, e in gaps([(s, e) for _, s, e, _ in self.device], self.lo, self.hi):
            mid = (s + e) // 2
            i = bisect.bisect_right(starts, mid)
            best = None
            for j in range(i - 1, max(i - 4000, -1), -1):
                hs, he, name = host[j]
                if he > mid and (best is None or he - hs < best[1] - best[0]):
                    best = (hs, he, name)
            key = short_name(best[2]) if best else "host outside any recorded range"
            acc[key] = acc.get(key, 0) + (e - s)
        return [[k, v / 1e9] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:top]]

    def under_range(self, pattern: str) -> float:
        """Device seconds of the operations whose launch (the host runtime
        call of the same correlation id) began inside a host range whose
        name matches `pattern`."""
        rx = re.compile(pattern)
        ranges = sorted((s, e) for name, s, e, _ in self.host if rx.search(name))
        if not ranges:
            return 0.0
        launched = {corr: s for name, s, e, corr in self.host if corr}
        total = 0
        starts = [r[0] for r in ranges]
        for _, s, e, corr in self.device:
            t = launched.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and ranges[i][0] <= t < ranges[i][1]:
                total += e - s
        return total / 1e9


def short_name(name: str) -> str:
    """A device operation's name without its argument list, at most 80 chars."""
    name = name.strip().replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0 and out and not "".join(out).endswith("operator"):
            break
        out.append(ch)
        depth += ch == "<"
        depth -= ch == ">"
    text = "".join(out)
    return (text[5:] if text.startswith("void ") else text)[:80]


def from_profiler(prof) -> Optional[Trace]:
    """A Trace of the `portbench.window` range of a torch.profiler session,
    or None where the session recorded no such range."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    lo = hi = None
    device, host = [], []
    for ev in events:
        s = ev.start_ns()
        e = s + ev.duration_ns()
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            if not ev.is_user_annotation():
                device.append((name, s, e, ev.correlation_id()))
        else:
            if name == WINDOW:
                lo, hi = s, e
            host.append((name, s, e, ev.correlation_id()))
    if lo is None:
        return None
    # host ranges are mirrored on the device's timeline as annotations,
    # which are no operations
    ranges = {name for name, _, _, _ in host}
    return Trace(lo, hi, [d for d in device if d[0] not in ranges], host)
