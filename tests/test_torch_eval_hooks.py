"""The in-training evaluation hooks and the writer, the port against the JAX
package on the CPU at TINY widths:

- make_diffusion_eval_fn: the GPT latent, the denoiser's conditioning, the
  cond-free DPM++(2M) (3 steps) and Vocos on the first row of an eval batch,
  with the state's weights and JAX's start noise (jax.random.normal of the
  step's key) injected: mel within 1e-4 and waveform within 1e-4 relative
  (L2) of JAX's; what each hands its writer;
- make_vqvae_eval_fn: the real and generated slices' loss mels within 1e-5
  relative of JAX's;
- the port's SummaryWriter: scalars as JSON lines, images and histograms as
  .npy arrays and audio as 16-bit .wav under logdir/<tag>/<step>;
- the Trainer calling eval_fn every eval_freq steps (default save_freq),
  after that step's checkpoint, with the state's current weights.

JAX's hooks render the mels with matplotlib (plot_spectrogram_to_numpy);
the test swaps that for the identity, so that both writers receive the
arrays. Weights: jax.eval_shape of each init filled from a numpy seed."""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_api import TINY as JTINY
from test_torch_codec_synth import rel, seeded_variables
from test_torch_config import TINY
from ttts_tpu.models import diffusion_net as jdn
from ttts_tpu.models import gpt as jgpt
from ttts_tpu.models import vocos as jvocos
from ttts_tpu.train import eval_hooks as jeval_hooks
from ttts_tpu_torch import porting
from ttts_tpu_torch.data.audio import load_wav
from ttts_tpu_torch.models.diffusion_net import AA_diffusion
from ttts_tpu_torch.models.gpt import UnifiedVoice
from ttts_tpu_torch.models.vocos import Vocos
from ttts_tpu_torch.train import eval_hooks
from ttts_tpu_torch.train.state import TrainState, make_adamw
from ttts_tpu_torch.train.trainer import Trainer
from ttts_tpu_torch.utils.logging import SummaryWriter

T, TR, CODES = 32, 24, 8
TOL = 1e-4


class Capture:
    """A writer that keeps what summarize receives."""

    def __init__(self):
        self.calls = []

    def summarize(self, step, **kw):
        self.calls.append((step, kw))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"text": rng.integers(1, 200, (2, 12)).astype(np.int32),
            "text_lengths": np.asarray([12, 9], np.int32),
            "mel_codes": rng.integers(0, 1024, (2, CODES)).astype(np.int32),
            "wav_lengths": np.asarray([CODES * 1024, 6 * 1024], np.int32),
            "mel": (rng.standard_normal((2, T, 100)) - 4.0).astype(np.float32),
            "mel_refer": (rng.standard_normal((2, TR, 100)) - 4.0).astype(np.float32)}


@pytest.fixture(scope="module")
def models():
    b = {k: jnp.asarray(v[:1]) for k, v in _batch().items()}
    jnet, jgpt_m, jvoc = (jdn.AA_diffusion(JTINY.diffusion_net), jgpt.UnifiedVoice(JTINY.gpt),
                          jvocos.Vocos(JTINY.vocos))
    nv = seeded_variables(lambda: jnet.init(jax.random.key(0), b["mel"], jnp.asarray([1.0]),
                                            jnp.zeros((1, 16, 64)), b["mel_refer"]), seed=1)
    gv = seeded_variables(lambda: jgpt_m.init(jax.random.key(0), b["text"], b["text_lengths"],
                                              b["mel_codes"], b["wav_lengths"]), seed=2)
    vv = seeded_variables(lambda: jvoc.init(jax.random.key(0), b["mel"]), seed=3)

    def port(cls, cfg, fn, variables):
        m = cls(cfg)
        m.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in fn(variables).items()})
        return m.eval()

    return {"jax": (jnet, nv, jgpt_m, gv, jvoc, vv),
            "net": port(AA_diffusion, TINY.diffusion_net, porting.aa_diffusion_state_dict, nv),
            "gpt": port(UnifiedVoice, TINY.gpt, porting.unified_voice_state_dict, gv),
            "vocos": port(Vocos, TINY.vocos, porting.vocos_state_dict, vv)}


def test_diffusion_eval_fn_matches_jax(models, monkeypatch, tmp_path):
    monkeypatch.setattr(jeval_hooks, "plot_spectrogram_to_numpy", lambda x: x)
    jnet, nv, jgpt_m, gv, jvoc, vv = models["jax"]
    step = 6
    jfn = jeval_hooks.make_diffusion_eval_fn(jnet, jgpt_m, gv, jvoc, vv, _batch(), steps=3)
    cap = Capture()
    jfn(step, types.SimpleNamespace(params=nv), cap)
    (jstep, want), = cap.calls
    noise = torch.from_numpy(np.asarray(jax.random.normal(jax.random.key(step), (1, T, 100))))
    sampler = AA_diffusion(TINY.diffusion_net)  # its weights come from the state
    fn = eval_hooks.make_diffusion_eval_fn(sampler, models["gpt"], models["vocos"], _batch(),
                                           steps=3)
    writer = SummaryWriter(tmp_path)
    mel, wav = fn(step, types.SimpleNamespace(model=models["net"]), writer, noise=noise)
    assert jstep == step
    jmel = want["images"]["eval/mel_generated"]
    assert mel.shape == (1, T, 100) and rel(mel[0].T.numpy(), jmel) <= TOL
    assert rel(wav[0].numpy(), want["audios"]["eval/sample"]) <= TOL
    np.testing.assert_array_equal(np.load(tmp_path / "eval/mel_target" / f"{step}.npy"),
                                  want["images"]["eval/mel_target"])
    np.testing.assert_array_equal(np.load(tmp_path / "eval/mel_generated" / f"{step}.npy"),
                                  mel[0].T.numpy())
    back, sr = load_wav(tmp_path / "eval/sample" / f"{step}.wav")
    assert sr == want["audio_sampling_rate"] == 24000
    np.testing.assert_allclose(back, np.clip(wav[0].numpy(), -1, 1), atol=1 / 32767 + 1e-7)


def test_diffusion_eval_fn_draws_its_noise_from_the_step(models):
    fn = eval_hooks.make_diffusion_eval_fn(AA_diffusion(TINY.diffusion_net), models["gpt"],
                                           models["vocos"], _batch(), steps=2)
    state = types.SimpleNamespace(model=models["net"])
    (a, _), (b, _), (c, _) = (fn(s, state, None) for s in (3, 3, 4))
    assert torch.equal(a, b) and not torch.equal(a, c) and torch.isfinite(a).all()


def test_vqvae_eval_fn_matches_jax(monkeypatch, tmp_path):
    monkeypatch.setattr(jeval_hooks, "plot_spectrogram_to_numpy", lambda x: x)
    rng = np.random.default_rng(1)
    y_real, y_hat = (0.3 * rng.standard_normal((2, 2560, 1))).astype(np.float32), (
        0.3 * rng.standard_normal((2, 2560, 1))).astype(np.float32)
    cap = Capture()
    jeval_hooks.make_vqvae_eval_fn(JTINY.audio)(5, None, cap, y_real=y_real, y_hat=y_hat)
    (_, want), = cap.calls
    fn = eval_hooks.make_vqvae_eval_fn(TINY.audio)
    assert fn(5, None, SummaryWriter(tmp_path)) is None
    real, gen = fn(5, None, SummaryWriter(tmp_path), y_real=y_real, y_hat=y_hat)
    assert rel(real[0].numpy(), want["images"]["eval/slice_mel_real"]) <= 1e-5
    assert rel(gen[0].numpy(), want["images"]["eval/slice_mel_gen"]) <= 1e-5
    for tag in ("eval/slice_mel_real", "eval/slice_mel_gen"):
        assert (tmp_path / tag / "5.npy").exists()
    back, sr = load_wav(tmp_path / "eval/slice_real" / "5.wav")
    assert sr == 32000 and len(back) == 2560


def test_writer_files(tmp_path):
    w = SummaryWriter(tmp_path)
    w.summarize(3, scalars={"loss": 1.5}, histograms={"h/w": np.arange(4.0)},
                images={"img": np.ones((2, 3))}, audios={"a": np.full(100, 0.25)},
                audio_sampling_rate=16000)
    w.summarize(4, scalars={"loss": 1.25})
    w.close()
    rows = [json.loads(line) for line in (tmp_path / "scalars.jsonl").read_text().splitlines()]
    assert [(r["step"], r["loss"]) for r in rows] == [(3, 1.5), (4, 1.25)]
    np.testing.assert_array_equal(np.load(tmp_path / "h/w" / "3.npy"), np.arange(4.0))
    np.testing.assert_array_equal(np.load(tmp_path / "img" / "3.npy"), np.ones((2, 3)))
    back, sr = load_wav(tmp_path / "a" / "3.wav")
    assert sr == 16000 and np.allclose(back, 0.25, atol=1 / 32767)


@pytest.mark.parametrize("eval_freq", [None, 2])
def test_trainer_calls_eval_fn(tmp_path, eval_freq):
    """eval_fn(step, state, writer) every eval_freq steps (default
    save_freq), after that step's checkpoint, seeing the weights the step
    left."""
    torch.manual_seed(0)
    model = torch.nn.Linear(3, 2)
    state = TrainState.create(model, lambda ps: make_adamw(ps, 0.1, 1))

    def step_fn(state, batch, key):
        loss = state.model(batch["x"]).square().mean()
        state.opt.update(torch.autograd.grad(loss, state.params))
        state.step += 1
        return {"loss": loss.detach()}

    seen = []

    def eval_fn(step, st, writer):
        seen.append((step, trainer.ckpt.latest_step(), st.model.weight.detach().clone(),
                     isinstance(writer, SummaryWriter)))

    data = [{"x": np.ones((4, 3), np.float32)}] * 8
    trainer = Trainer(step_fn, state, data, str(tmp_path), train_steps=6, save_freq=3,
                      eval_fn=eval_fn, eval_freq=eval_freq, device="cpu")
    trainer.train()
    steps = [2, 4, 6] if eval_freq else [3, 6]
    assert [s for s, *_ in seen] == steps
    for s, latest, weight, is_writer in seen:
        assert is_writer and latest == ((s // 3) * 3 or None)
    assert torch.equal(seen[-1][2], model.weight.detach())
    assert not torch.equal(seen[0][2], seen[-1][2])
