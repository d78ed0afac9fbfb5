"""The grouped expert kernel's share of its roofline over the traced calls:
the bound of every call it made (portbench/roofline/moe_experts.py, from
the moe counters the calls recorded: pairs and experts read, by pairs a
call), against the device time of its two kernels, scaled to the launches
expected where the profiler caught fewer; nothing without its kernels or
counters."""

from portbench.roofline import bound_s


def read(r):
    if r.trace is None:
        return None
    c = r.ctx.cfg
    mod = r.roofline("moe_experts")
    bound, launches = 0.0, 0
    for rec in r.traced:
        for p, (pairs, read) in rec.get("moe", {}).items():
            bound += bound_s(mod.work(pairs, read, c["hidden_size"], c["moe_intermediate_size"]),
                             r.peaks)
            launches += mod.LAUNCHES_PER_CALL * (pairs // int(p))
    seen, seconds = r.trace.kernels(mod.KERNELS)
    if not seen or not seconds or not launches:
        return None
    return 100.0 * bound / (seconds * launches / seen)
