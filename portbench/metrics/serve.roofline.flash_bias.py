"""The bias-mode attention kernel (D = 32) over the traced calls: every
launch of the trunk (steps x (3 integrator + the trunk's layers) at 2n rows
and T = 4 x bucket) and of the conditioning's latent and reference
encoders (3 each, n rows, at the latent's and the reference mel's
lengths), against the kernel's device time."""

from portbench.readers import roofline_share


def read(r):
    c, p = r.ctx.cfg["ttts"], r.ctx.params
    dn = c["diffusion_net"]
    h = dn["num_heads"]
    d = dn["model_channels"] // h
    launches = []
    for rec in r.traced:
        n, bucket = len(rec["texts"]), _bucket(rec)
        launches += [(p["diffusion_steps"] * (3 + dn["num_layers"]), (2 * n, 4 * bucket, h, d)),
                     (3, (n, bucket, h, d)), (3, (n, r.ctx.t_ref, h, d))]
    return roofline_share(r, "flash_bias", launches)


def _bucket(rec):
    return min(-(-max(rec["code_lens"]) // 32) * 32, len(rec["codes"][0]))
