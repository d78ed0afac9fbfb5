"""GPT decode: the share of the program's `ttts.stage.gpt_decode` spans
(prefill and the decode loop) in the profiled calls with no operation
running on the card."""

from portbench.spans import idle_share_in


def read(r):
    return idle_share_in(r, "ttts.stage.gpt_decode")
