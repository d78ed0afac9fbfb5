"""What the readers of the program's own spans share. The program names
stretches of its work with torch.profiler host ranges called `ttts.*`
(ttts_tpu_torch/utils/logging.span), recorded on the clock the device
events share. A reader counts a span's ranges in the traced window, sums
the device time launched inside them, or measures the device's idle share
inside them. Each gives None on a trace without the span, as on a program
that records none.

A device operation is matched to its launch through the CUDA API call
(`cudaLaunchKernel`, `cuLaunchKernelEx`, ...) that carries its correlation
id, and to no other host event: torch's own ops and ranges carry ids of a
counter of their own, which coincide with CUPTI's (`Trace.under_range`
matches any host event).
"""

from __future__ import annotations

import bisect
import re
from typing import List, Optional, Tuple

from portbench.trace import union_length

LAUNCH = re.compile(r"^cu(da)?[A-Z]")  # cudaLaunchKernel, cuLaunchKernelEx, cudaMemcpyAsync, ...


def ranges(trace, name: str) -> List[Tuple[int, int]]:
    """The host ranges called `name` that start in the traced window."""
    if trace is None:
        return []
    return sorted((s, e) for n, s, e, _ in trace.host if n == name and trace.lo <= s < trace.hi)


def launched_under(trace, name: str) -> float:
    """Device seconds of the operations whose launch call began inside a
    `name` range."""
    spans = ranges(trace, name)
    if not spans:
        return 0.0
    starts = [s for s, _ in spans]
    launched = {corr: s for n, s, _, corr in trace.host if corr and LAUNCH.match(n)}
    total = 0
    for _, s, e, corr in trace.device:
        t = launched.get(corr)
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < spans[i][1]:
            total += e - s
    return total / 1e9


def ms_per_range(r, name: str) -> Optional[float]:
    """Device ms launched inside the `name` ranges, over their number."""
    n = len(ranges(r.trace, name))
    return launched_under(r.trace, name) * 1e3 / n if n else None


def idle_share_in(r, name: str) -> Optional[float]:
    """The share (%) of the `name` ranges' length with no device operation
    running (the union of the device's operation intervals inside each)."""
    spans = ranges(r.trace, name)
    length = sum(e - s for s, e in spans)
    if not length:
        return None
    device = [(s, e) for _, s, e, _ in r.trace.device]
    busy = sum(union_length(device, s, e) for s, e in spans)
    return 100.0 * (1.0 - busy / length)


def device_share(r, name: str) -> Optional[float]:
    """The share (%) of the traced units' device time launched inside the
    `name` ranges (the base of train.optimizer_share: every device
    operation's time)."""
    if not ranges(r.trace, name):
        return None
    total = sum(e - s for _, s, e, _ in r.trace.device) / 1e9
    return 100.0 * launched_under(r.trace, name) / total if total else None
