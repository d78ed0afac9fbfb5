"""Traffic kind `serve_batch`: one client in a closed loop of batched
zero-shot calls, `TextToSpeech.tts_batch` back to back in one cloned voice.

Parameters (the workload file's `params`):
  texts_per_call      texts of one call
  texts               the pinyin texts a call repeats, in turn, to make up
                      its texts_per_call, in an order drawn from the seed
  preset              "fast" / "ultra_fast" / ... (candidates, rerank, steps)
  max_generate_length codes a stream runs to (the stop code is held down)
  voice_seconds, voice_rate   the one synthetic voice, cached after set-up
  greedy_stride       every greedy_stride-th decode row draws greedily (its
                      Gumbel noise is zero): the rows whose logits are checked
  check_calls         calls of the window the check samples
  check_texts         texts of each such call the check compares, drawn from
                      the seed among those with a greedy row, the longest in
  trace_units         calls timed by stage, then calls under the profiler, in
                      a traced run

The seed makes the weights, the voice, the texts and every call's draws;
every seed gives the same sizes of work.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import check as chk
from portbench import weights as wts

SR_OUT = 24000


class Draws:
    """A call's random draws (the program's `draws` argument): the Gumbel
    noise of every decode step, zero on the greedy rows, then the diffusion
    start noise, both from one generator on the card seeded per call."""

    def __init__(self, seed: int, device, greedy_stride: int):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.stride = greedy_stride

    def gumbel(self, shape):
        u = torch.rand(shape, generator=self.gen, device=self.device)
        g = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
        g[:, greedy_rows(shape[1], self.stride)] = 0.0
        return g

    def normal(self, shape):
        return torch.randn(shape, generator=self.gen, device=self.device)


def greedy_rows(rows: int, stride: int) -> list:
    return list(range(0, rows, stride))


def synthetic_voice(seconds: float, sr: int, seed: int) -> np.ndarray:
    """A seeded voice-like signal: a gliding harmonic tone with noise."""
    rng = np.random.default_rng(wts.module_seed(seed, "voice"))
    t = np.arange(int(seconds * sr)) / sr
    f0 = 140.0 + 30.0 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    wav = sum(np.sin(k * phase) / k for k in range(1, 6))
    wav = 0.3 * wav * (0.6 + 0.4 * np.sin(2 * np.pi * 3.0 * t) ** 2)
    return (wav + 0.01 * rng.standard_normal(t.size)).astype(np.float32)


def texts_of(params: dict, seed: int, call: int) -> list:
    """The call's texts: params["texts"] repeated in turn to texts_per_call,
    in an order drawn from (seed, call)."""
    n, pool = int(params["texts_per_call"]), params["texts"]
    rng = np.random.default_rng(wts.module_seed(seed, f"texts{call}"))
    return [pool[i % len(pool)] for i in rng.permutation(n)]


def call_seed(seed: int, call: int) -> int:
    return wts.module_seed(seed, f"call{call}")


def port_config(cfg_file: dict):
    from ttts_tpu_torch.config import TTTSConfig, _from_dict

    return _from_dict(TTTSConfig, cfg_file["ttts"])


def modules_of(tts) -> dict:
    return {"gpt": tts.gpt, "clvp": tts.clvp, "diffusion": tts.diffusion, "vocos": tts.vocos,
            "codec": tts.codec}


def make_weights(ctx, module: str, shapes) -> dict:
    state = wts.make_state(shapes, ctx.seed, module, ctx.device)
    if module == "gpt":
        wts.hold_stop_code(state, ctx.cfg["ttts"]["gpt"]["stop_mel_token"])
    return state


def setup(ctx) -> None:
    from ttts_tpu_torch.api import PRESETS, TextToSpeech

    p = ctx.params
    preset = PRESETS[p["preset"]]
    if (preset["num_autoregressive_samples"], preset["diffusion_iterations"]) != (
            p["candidates"], p["diffusion_steps"]):
        raise ValueError(f"preset {p['preset']!r} is {preset}, the workload file says "
                         f"{p['candidates']} candidates and {p['diffusion_steps']} steps")
    tts = TextToSpeech(port_config(ctx.cfg), device=ctx.device, seed=0)
    with torch.no_grad():
        for name, mod in modules_of(tts).items():
            mod.load_state_dict(make_weights(ctx, name, wts.shapes_of(mod)), strict=True)
    tts._cond_cache.clear()
    ctx.tts = tts
    ctx.voice = synthetic_voice(p["voice_seconds"], p["voice_rate"], ctx.seed)
    ctx.capture = {}
    ctx.hooks = [
        tts.gpt.register_forward_hook(lambda m, a, out: ctx.capture.__setitem__("latent", out)),
        tts.vocos.register_forward_pre_hook(
            lambda m, a: ctx.capture.__setitem__("mel", a[0])),
        tts.clvp.register_forward_hook(lambda m, a, out: ctx.capture.__setitem__("sims", out)),
    ]
    prompt, refer = tts.get_conditioning(ctx.voice, p["voice_rate"], "voice")
    ctx.lp, ctx.t_ref = -(-prompt.shape[1] // 16) * 16, refer.shape[1]
    # warm up: a call of the same sizes with draws of their own
    _call(ctx, texts_of(p, ctx.seed, -1), call_seed(ctx.seed, -1))


def stage_times(ctx, on: bool) -> None:
    """Stage times on or off: each stage then ends in a synchronise, so they
    are taken only in calls after a traced run's window."""
    ctx.tts.profile_stages = on


def _call(ctx, texts, seed):
    p = ctx.params
    draws = Draws(seed, ctx.device, int(p["greedy_stride"]))
    return ctx.tts.tts_batch(texts, ctx.voice, p["voice_rate"], p["preset"],
                             int(p["max_generate_length"]), voice_cache_key="voice",
                             draws=draws)


def unit(ctx, i: int) -> dict:
    texts = texts_of(ctx.params, ctx.seed, i)
    seed = call_seed(ctx.seed, i)
    t0 = time.perf_counter()
    wavs = _call(ctx, texts, seed)
    tts = ctx.tts
    return {"requests": len(texts), "audio_s": sum(len(w) for w in wavs) / SR_OUT,
            "wall_s": time.perf_counter() - t0, "texts": texts, "seed": seed, "wavs": wavs,
            "codes": tts.last_codes, "best": list(tts.last_best),
            "code_lens": list(tts.last_code_lens),
            "stages": dict(tts.last_stage_times) if tts.profile_stages else {},
            "latent": ctx.capture.get("latent"), "mel": ctx.capture.get("mel"),
            "sims": ctx.capture.pop("sims", None)}


def end_to_end(ctx, records, window_s: float) -> dict:
    return {"audio_s_per_s": sum(r["audio_s"] for r in records) / window_s}


def checked(ctx, records) -> list:
    """The calls the check compares, drawn from the seed, each with the
    texts it compares under "check" (see check_texts); the other calls'
    captures and the program's state are freed."""
    p = ctx.params
    rng = np.random.default_rng(wts.module_seed(ctx.seed, "check"))
    pick = sorted(rng.choice(len(records), min(int(p["check_calls"]), len(records)),
                             replace=False).tolist())
    for i, r in enumerate(records):
        if i not in pick:
            r["latent"] = r["mel"] = r["sims"] = None
    for h in ctx.hooks:
        h.remove()
    del ctx.tts, ctx.capture
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    calls = [records[i] for i in pick]
    for call in calls:
        call["check"] = check_texts(p, call["texts"], rng)
    return calls


def check_texts(p: dict, texts: list, rng) -> list:
    """Indices of check_texts texts that have a greedy decode row, drawn by
    `rng`, the longest such text always among them."""
    k, stride = int(p["candidates"]), int(p["greedy_stride"])
    greedy = sorted({r // k for r in greedy_rows(len(texts) * k, stride)})
    longest = max(greedy, key=lambda t: (len(texts[t].split()), -t))
    rest = [t for t in greedy if t != longest]
    more = rng.choice(len(rest), min(int(p["check_texts"]) - 1, len(rest)), replace=False)
    return sorted([longest] + [rest[i] for i in more])


def check(ctx, records) -> list:
    """The numbers compared (see portbench/check.py), on texts of calls of
    the window drawn from the seed, after the program's state is freed."""
    calls = checked(ctx, records)
    readings = chk.serve_readings(ctx, calls, chk.ServeReference(ctx, make_weights),
                                  noise_of(ctx))
    return chk.compared(ctx.limits, readings)


def noise_of(ctx):
    """call, n, bucket → the call's diffusion start noise, drawn again: the
    same generator after the same Gumbel draw."""
    p, c = ctx.params, ctx.cfg["ttts"]

    def noise(call, n: int, bucket: int):
        d = Draws(call["seed"], ctx.device, int(p["greedy_stride"]))
        d.gumbel((int(p["max_generate_length"]), len(call["codes"]),
                  int(c["gpt"]["number_mel_codes"])))
        return d.normal((n, 4 * bucket, int(c["diffusion_net"]["in_channels"])))

    return noise


def control(ctx, records) -> dict:
    """The control's readings on the texts the check would take: the
    reference lowered to fp8 in the program's place (portbench/lowp.py)."""
    calls = checked(ctx, records)
    ref = chk.ServeReference(ctx, make_weights)
    return chk.serve_readings(ctx, calls, ref, noise_of(ctx), control=ref.lowered())
