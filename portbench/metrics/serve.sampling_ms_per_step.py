"""GPT decode, the sampler: device ms launched inside the program's
`ttts.gpt.sample` spans (the warpers, the draw and the token writes of a
decode step) over their number, in the profiled calls."""

from portbench.spans import ms_per_range


def read(r):
    return ms_per_range(r, "ttts.gpt.sample")
