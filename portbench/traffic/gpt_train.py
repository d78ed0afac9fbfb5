"""Traffic kind `gpt_train`: `train.steps.gpt_train_step` back to back on
one TrainState (the GPT under bf16 autocast and the configuration's AdamW),
fed a cycle of batches.

The configuration file's `compute_dtype` is the step's autocast dtype.

Parameters (the workload file's `params`):
  cycle        the batches of one cycle, each {"text": [row lengths],
               "mel": [row lengths], "text_pad": Lt, "mel_pad": Lm}: rows
               are padded to Lt text tokens and Lm mel codes
  trace_units  steps under the profiler in a traced run
  check_block  the reference's rows per block (memory)

The seed draws every row's tokens and the order of the cycle; the shapes
and lengths are the file's, so every seed does the same work. Set-up
drives the state through its first three steps, on three batches whose
rows all differ, through the window's own call, and records what the check
compares; then one step of each other shape warms it up. The window
continues the same state.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import check as chk
from portbench import weights as wts

FIRST = 3  # steps the reference follows


def port_gpt_config(cfg_file: dict):
    from ttts_tpu_torch.config import GPTConfig, _from_dict

    return _from_dict(GPTConfig, cfg_file["ttts"]["gpt"])


def make_batch(spec: dict, seed: int, device) -> dict:
    """One batch of the cycle with its tokens drawn on the card from `seed`:
    text ids 1..254 and mel codes 0..1023 up to each row's length, zero
    padding past it."""
    text_len = torch.as_tensor(spec["text"], device=device)
    mel_len = torch.as_tensor(spec["mel"], device=device)
    b, lt, lm = len(spec["text"]), int(spec["text_pad"]), int(spec["mel_pad"])
    g = torch.Generator(device=device).manual_seed(seed)
    text = torch.randint(1, 255, (b, lt), generator=g, device=device)
    mel = torch.randint(0, 1024, (b, lm), generator=g, device=device)
    text = torch.where(torch.arange(lt, device=device)[None] < text_len[:, None], text, 0)
    mel = torch.where(torch.arange(lm, device=device)[None] < mel_len[:, None], mel, 0)
    return {"text": text, "text_lengths": text_len, "mel_codes": mel,
            "wav_lengths": mel_len * 1024}


def tokens_of(spec: dict) -> int:
    """The unpadded text + mel tokens of a batch."""
    return int(sum(spec["text"]) + sum(spec["mel"]))


def start_weights(ctx, model) -> dict:
    return wts.make_state(wts.shapes_of(model), ctx.seed, "gpt", ctx.device)


def setup(ctx) -> None:
    from ttts_tpu_torch.models.gpt import UnifiedVoice
    from ttts_tpu_torch.train.state import TrainState, make_adamw
    from ttts_tpu_torch.train.steps import gpt_train_step

    t = ctx.cfg["ttts"]["train"]
    with torch.device(ctx.device):
        model = UnifiedVoice(port_gpt_config(ctx.cfg))
    with torch.no_grad():
        model.load_state_dict(start_weights(ctx, model), strict=True)
    ctx.state = TrainState.create(model, lambda ps: make_adamw(
        ps, t["lr"], t["warmup_steps"], tuple(t["betas"]), t["weight_decay"], t["grad_clip"],
        t["eps"]))
    ctx.step_fn = gpt_train_step
    cycle = ctx.params["cycle"]
    rng = np.random.default_rng(wts.module_seed(ctx.seed, "order"))
    ctx.order = rng.permutation(len(cycle)).tolist()
    ctx.batches = [make_batch(cycle[j], wts.module_seed(ctx.seed, f"batch{j}"), ctx.device)
                   for j in range(len(cycle))]
    # the first steps, whose rows all differ: the reference follows them
    first = [_first_batch(ctx, i) for i in range(FIRST)]
    names = [n for n, _ in model.named_parameters()]
    losses, grad1 = [], None
    b1 = float(t["betas"][0])
    for i, batch in enumerate(first):
        out = _step(ctx, batch, i)
        losses.append(float(out["loss"]))
        if i == 0:  # the first moment after one step is (1 - b1) g
            state = ctx.state.opt.opt.state
            grad1 = {n: float(state[p]["exp_avg"].norm()) / (1 - b1) if "exp_avg" in
                     state.get(p, {}) else 0.0 for n, p in zip(names, ctx.state.params)}
    start = start_weights(ctx, model)
    delta = {n: (p.detach() - start[n]) for n, p in model.named_parameters()}
    ctx.first = {"losses": losses, "grad1": grad1, "delta": delta}
    ctx.first_batches = first
    # one step of every shape of the cycle not met yet
    seen = {tuple(first[0]["text"].shape) + tuple(first[0]["mel_codes"].shape)}
    for j, batch in enumerate(ctx.batches):
        key = tuple(batch["text"].shape) + tuple(batch["mel_codes"].shape)
        if key not in seen:
            seen.add(key)
            _step(ctx, batch, FIRST + j)


def _first_batch(ctx, i: int) -> dict:
    """The i-th first step's batch: the cycle's first batch (in the seed's
    order) with tokens drawn afresh, so no two of the first steps share a row."""
    spec = ctx.params["cycle"][ctx.order[0]]
    return make_batch(spec, wts.module_seed(ctx.seed, f"first{i}"), ctx.device)


def _step(ctx, batch, key: int):
    return ctx.step_fn(ctx.state, batch, key,
                       amp_dtype=getattr(torch, ctx.cfg["compute_dtype"]))


def unit(ctx, i: int) -> dict:
    j = ctx.order[i % len(ctx.order)]
    spec = ctx.params["cycle"][j]
    _step(ctx, ctx.batches[j], FIRST + len(ctx.order) + i)
    return {"requests": 1, "tokens": tokens_of(spec), "batch": j, "rows": len(spec["text"]),
            "text_pad": int(spec["text_pad"]), "mel_pad": int(spec["mel_pad"])}


def end_to_end(ctx, records, window_s: float) -> dict:
    return {"train_tokens_per_s": sum(r["tokens"] for r in records) / window_s}


def check(ctx, records) -> list:
    """The numbers compared (portbench/check.py) on the first three steps."""
    from portbench.reference.gpt import UnifiedVoice as RefGPT

    del ctx.state
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    c = chk.ref_config(ctx.cfg)
    with torch.device(ctx.device):
        ref = RefGPT(c.gpt)
    start = start_weights(ctx, ref)
    with torch.no_grad():
        ref.load_state_dict(start, strict=True)
    t = ctx.cfg["ttts"]["train"]
    steps = chk.reference_steps(ref.train(), ctx.first_batches, t, float(t["text_weight"]),
                                float(t["mel_weight"]), int(ctx.params["check_block"]))
    readings = chk.train_readings(ctx.first, steps, start)
    return chk.compared(ctx.limits, readings)


def control(ctx, records) -> dict:
    """The control's readings: the reference lowered to fp8 (portbench/
    lowp.py) takes the program's place in the first three steps."""
    from portbench import lowp
    from portbench.reference.gpt import UnifiedVoice as RefGPT

    del ctx.state
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    c = chk.ref_config(ctx.cfg)
    t = ctx.cfg["ttts"]["train"]
    runs = []
    for low in (False, True):
        with torch.device(ctx.device):
            ref = RefGPT(c.gpt)
        start = start_weights(ctx, ref)
        with torch.no_grad():
            ref.load_state_dict(start, strict=True)
        if low:
            lowp.lower(ref)
        runs.append(chk.reference_steps(ref.train(), ctx.first_batches, t,
                                        float(t["text_weight"]), float(t["mel_weight"]),
                                        int(ctx.params["check_block"])))
    want, low = runs
    low["delta"] = {k: low["params"][k] - start[k] for k in want["grad1"]}
    return chk.train_readings(low, want, start)
