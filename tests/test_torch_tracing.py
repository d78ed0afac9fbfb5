"""The port's spans (utils.logging.span) and the serving call's stage times,
on the CPU at TINY widths:

- with no profiler recording and `profile_stages` off, a serving call and
  a GPT train step enter no `record_function` and make no CUDA event;
- under torch.profiler every `ttts.*` span of PERF.md section 3 is
  recorded: `ttts.gpt.sample` inside `ttts.gpt.decode_step` inside
  `ttts.stage.gpt_decode`, one `decode_step` a step the decode loop ran,
  the eight stages one after another inside the call; the train step's
  forward, backward and update in turn;
- with `profile_stages` on, `last_stage_times` holds the eight stages,
  none negative."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from test_torch_config import TINY
from ttts_tpu_torch.api import TextToSpeech
from ttts_tpu_torch.models.gpt import UnifiedVoice
from ttts_tpu_torch.train.state import TrainState, make_adamw
from ttts_tpu_torch.train.steps import gpt_train_step

STAGES = ["conditioning", "gpt_decode", "clvp_rerank", "select", "latent_and_cond",
          "diffusion", "vocos", "to_host"]
TEXTS = ["ni3 hao3", "shi4 jie4 hao3"]
MAX_GEN = 12


@pytest.fixture(scope="module")
def tts():
    return TextToSpeech(TINY, device="cpu", seed=1)


@pytest.fixture(scope="module")
def voice():
    rng = np.random.default_rng(0)
    t = np.arange(44100) / 44100
    return (0.3 * np.sin(2 * np.pi * 180 * t) + 0.05 * rng.standard_normal(t.size)
            ).astype(np.float32)


def _serve(tts, voice, preset="fast"):
    return tts.tts_batch(TEXTS, voice, 44100, preset=preset, max_generate_length=MAX_GEN,
                         seed=3, voice_cache_key="v")


def _train_state():
    torch.manual_seed(0)
    model = UnifiedVoice(dataclasses.replace(TINY.gpt, dropout=0.0))
    return TrainState.create(model, lambda ps: make_adamw(ps, 1e-3, 10), ema=True)


def _train_batch(b=2, lt=12, lm=20):
    g = torch.Generator().manual_seed(0)
    return {"text": torch.randint(1, 200, (b, lt), generator=g),
            "text_lengths": torch.full((b,), lt), "mel_codes": torch.randint(0, 1024, (b, lm),
                                                                             generator=g),
            "wav_lengths": torch.full((b,), lm * 1024)}


def _steps_run(codes: np.ndarray, stop: int) -> int:
    """The iterations of the decode loop that drew `codes`: it ends at the
    step in which the last row drew its stop code."""
    firsts = [np.flatnonzero(row == stop) for row in codes]
    if any(len(f) == 0 for f in firsts):
        return codes.shape[1]
    return max(int(f[0]) for f in firsts) + 1


def _ranges(prof, prefix: str):
    """{name: sorted [(start, end)] ns} of the recorded host ranges whose
    name starts with `prefix`."""
    out = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith(prefix) and ev.device_type() == torch.autograd.DeviceType.CPU:
            out.setdefault(ev.name(), []).append((ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    return {k: sorted(v) for k, v in out.items()}


def _inside(inner, outer) -> bool:
    return all(any(s >= os_ and e <= oe for os_, oe in outer) for s, e in inner)


def test_untraced_calls_enter_no_range_and_make_no_event(tts, voice, monkeypatch):
    made = []

    class Counting:
        def __init__(self, *a, **k):
            made.append(type(self).__name__)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    monkeypatch.setattr(torch.cuda, "Event", Counting)
    assert not tts.profile_stages
    _serve(tts, voice, "ultra_fast")
    assert tts.last_stage_times == {}
    gpt_train_step(_train_state(), _train_batch(), 0)
    assert made == []


def test_serving_spans_nest_and_tile_the_call(tts, voice):
    _serve(tts, voice)  # the conditioning cached: the traced call below runs as the window's
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("call"):
            _serve(tts, voice)
    got = _ranges(prof, "ttts.")
    (call,) = _ranges(prof, "call")["call"]
    stages = sorted((s, e, n[len("ttts.stage."):]) for n, v in got.items()
                    if n.startswith("ttts.stage.") for s, e in v)
    assert [n for _, _, n in stages] == STAGES
    assert all(e0 <= s1 for (_, e0, _), (s1, _, _) in zip(stages, stages[1:]))
    assert call[0] <= stages[0][0] and stages[-1][1] <= call[1]
    steps = _steps_run(tts.last_codes, tts.cfg.gpt.stop_mel_token)
    assert len(got["ttts.gpt.decode_step"]) == len(got["ttts.gpt.sample"]) == steps
    assert _inside(got["ttts.gpt.sample"], got["ttts.gpt.decode_step"])
    assert _inside(got["ttts.gpt.decode_step"], got["ttts.stage.gpt_decode"])


def test_train_step_spans():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gpt_train_step(_train_state(), _train_batch(), 0)
    got = _ranges(prof, "ttts.")
    order = [n for n, _ in sorted(((n, s) for n, v in got.items() for s, _ in v),
                                  key=lambda t: t[1])]
    assert order == ["ttts.train.forward", "ttts.train.backward", "ttts.train.update"]


@pytest.mark.parametrize("preset", ["ultra_fast", "fast"])
def test_stage_times(tts, voice, preset):
    tts.profile_stages = True
    try:
        _serve(tts, voice, preset)
    finally:
        tts.profile_stages = False
    times = tts.last_stage_times
    assert list(times) == STAGES
    assert all(v >= 0 for v in times.values())
