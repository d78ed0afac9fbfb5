"""The optimizer: the device time of the operations launched inside the
profiler's `Optimizer.step#AdamW.step` range (the update; the clip runs
before it) over the device time of the traced steps."""


def read(r):
    if r.trace is None:
        return None
    total = sum(e - s for _, s, e, _ in r.trace.device) / 1e9
    opt = r.trace.under_range(r"^Optimizer\.step#AdamW\.step$")
    return 100.0 * opt / total if total and opt else None
