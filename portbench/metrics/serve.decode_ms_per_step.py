"""GPT decode: ms of the `gpt_decode` stage (prefill and the decode loop)
a decode step, over the calls timed by stage after a traced run's window."""

from portbench.readers import stage_mean


def read(r):
    return stage_mean(r, "gpt_decode", float(r.ctx.params["max_generate_length"]))
