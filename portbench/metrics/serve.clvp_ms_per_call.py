"""CLVP rerank: ms of the `clvp_rerank` stage a call, over the calls timed
by stage after a traced run's window; nothing where the preset has one
candidate."""

from portbench.readers import stage_mean


def read(r):
    if int(r.ctx.params["candidates"]) < 2:
        return None
    return stage_mean(r, "clvp_rerank")
