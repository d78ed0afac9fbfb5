"""MoE experts: device ms of the grouped expert kernel launched inside the
program's `ttts.gpt.decode_step` spans (a replayed step's kernels carry its
`cudaGraphLaunch`'s id) over their number, in the profiled calls; nothing
on a trace without the span or the kernel."""

import bisect
import re

from portbench.spans import LAUNCH, ranges


def read(r):
    steps = ranges(r.trace, "ttts.gpt.decode_step")
    if not steps:
        return None
    rx = re.compile(r.roofline("moe_experts").KERNELS)
    starts = [s for s, _ in steps]
    launched = {corr: s for n, s, _, corr in r.trace.host if corr and LAUNCH.match(n)}
    total, found = 0, False
    for name, s, e, corr in r.trace.device:
        if not rx.search(name):
            continue
        found = True
        t = launched.get(corr)
        i = -1 if t is None else bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < steps[i][1]:
            total += e - s
    return total / 1e6 / len(steps) if found else None
