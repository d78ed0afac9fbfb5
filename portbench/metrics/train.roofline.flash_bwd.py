"""The flash route's causal backward over the traced steps: one call (the
dQ and the dK/dV launch) a layer and step at (rows, T = text + 2 + mel + 2,
heads, head dim)."""

from portbench.readers import roofline_share


def read(r):
    g = r.ctx.cfg["ttts"]["gpt"]
    h, d = g["heads"], g["model_dim"] // g["heads"]
    launches = [(g["layers"], (rec["rows"], rec["text_pad"] + rec["mel_pad"] + 4, h, d))
                for rec in r.traced]
    return roofline_share(r, "flash_bwd", launches)
