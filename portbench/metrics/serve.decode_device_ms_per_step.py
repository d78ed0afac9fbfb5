"""GPT decode: device ms launched inside the program's `ttts.gpt.decode_step`
spans (a decode step: the draw, the stop test, the model's step) over their
number, in the profiled calls; beside `serve.decode_ms_per_step`, the wall
of a step, it gives the decode's host-paced share."""

from portbench.spans import ms_per_range


def read(r):
    return ms_per_range(r, "ttts.gpt.decode_step")
