"""The whole step: the benchmark's model FLOPs of every step of the window
(portbench/flops.py) over the window's time and the bf16 peak. Each row is
counted at its own text and mel lengths: padding is not model work."""

from portbench import flops


def read(r):
    g = r.ctx.cfg["ttts"]["gpt"]
    cycle = r.ctx.params["cycle"]
    per_batch = {}
    for rec in r.records:
        j = rec["batch"]
        if j not in per_batch:
            spec = cycle[j]
            per_batch[j] = sum(flops.gpt_train_step(
                1, lt, lm, g["model_dim"], g["layers"], g["number_text_tokens"] + 1,
                g["number_mel_codes"]) for lt, lm in zip(spec["text"], spec["mel"]))
    total = sum(per_batch[rec["batch"]] for rec in r.records)
    return 100.0 * total / (r.window_s * r.peaks["bf16_flop_s"])
