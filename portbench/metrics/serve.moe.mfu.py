"""The whole call with the MLA-MoE speech LM: the benchmark's model FLOPs of
every call of the window (portbench/flops_mla_moe.py: the trunk's active
parameters, 6 routed experts of 64, the shared ones, attention and its
products over the latent cache; the rest of the pipeline as
portbench/flops.py counts it) over the window's time and the bf16 peak."""

from portbench import flops_mla_moe
from portbench.readers import text_pad


def read(r):
    p = r.ctx.params
    total = 0.0
    for rec in r.records:
        n = len(rec["texts"])
        bucket = min(-(-max(rec["code_lens"]) // 32) * 32, len(rec["codes"][0]))
        total += sum(flops_mla_moe.serve_call(
            r.ctx.cfg, n, int(p["candidates"]), text_pad(rec["texts"]), r.ctx.lp,
            int(p["max_generate_length"]), bucket, int(p["diffusion_steps"]),
            r.ctx.t_ref).values())
    return 100.0 * total / (r.window_s * r.peaks["bf16_flop_s"])
