"""The diffusion tail: ms of the `diffusion` stage a sampler step, over the
calls timed by stage after a traced run's window."""

from portbench.readers import stage_mean


def read(r):
    return stage_mean(r, "diffusion", float(r.ctx.params["diffusion_steps"]))
