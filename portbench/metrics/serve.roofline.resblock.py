"""The scale-shift resblock kernel (five launches a call) over the traced
calls: steps x (3 integrator + the trunk's layers + 3) calls at 2n rows
and T = 4 x bucket, against the device time of its five kernels."""

from portbench.readers import roofline_share


def read(r):
    c, p = r.ctx.cfg["ttts"], r.ctx.params
    dn = c["diffusion_net"]
    launches = []
    for rec in r.traced:
        n = len(rec["texts"])
        bucket = min(-(-max(rec["code_lens"]) // 32) * 32, len(rec["codes"][0]))
        launches.append((p["diffusion_steps"] * (3 + dn["num_layers"] + 3),
                         (2 * n, 4 * bucket, dn["model_channels"])))
    return roofline_share(r, "resblock", launches)
