"""The whole call: the benchmark's model FLOPs of every call of the window
(portbench/flops.py) over the window's time and the bf16 peak. A traced
run's window runs as an untraced one's: no stage times, no profiler."""

from portbench import flops
from portbench.readers import text_pad


def read(r):
    p = r.ctx.params
    total = 0.0
    for rec in r.records:
        n = len(rec["texts"])
        bucket = min(-(-max(rec["code_lens"]) // 32) * 32, len(rec["codes"][0]))
        total += sum(flops.serve_call(
            r.ctx.cfg, n, int(p["candidates"]), text_pad(rec["texts"]), r.ctx.lp,
            int(p["max_generate_length"]), bucket, int(p["diffusion_steps"]),
            r.ctx.t_ref).values())
    return 100.0 * total / (r.window_s * r.peaks["bf16_flop_s"])
