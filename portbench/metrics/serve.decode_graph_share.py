"""GPT decode: the share (%) of the program's `ttts.gpt.decode_step` spans,
in the profiled calls, inside which a CUDA graph launch (`cudaGraphLaunch`)
began: 100 where every decode step replays a captured graph, 0 where every
step launches its operations one by one; nothing on a trace without the
span."""

import bisect

from portbench.spans import ranges


def read(r):
    steps = ranges(r.trace, "ttts.gpt.decode_step")
    if not steps:
        return None
    starts = sorted(s for n, s, _, _ in r.trace.host if n == "cudaGraphLaunch")
    replayed = 0
    for s, e in steps:
        i = bisect.bisect_left(starts, s)
        replayed += i < len(starts) and starts[i] < e
    return 100.0 * replayed / len(steps)
