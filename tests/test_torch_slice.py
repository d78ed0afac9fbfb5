"""PyTorch port parity of the whole serving slice: TextToSpeech.tts at
presets "fast" (4 candidates, CLVP rerank, 50 steps; the default) and
"ultra_fast" on the TINY config, JAX weights carried into the port through
ttts_tpu_torch.porting, and JAX's own random draws injected (the decode
loop's Gumbel noise per api.py:487,499 / gpt.py:540, and the diffusion start
noise per api.py:470-472).

Contract: prompt codes and every candidate's codes equal, the same CLVP
winner, waveform within 5e-4, the band of the JAX golden snapshot
(tests/test_api.py:142-144)."""

import jax
import numpy as np
import pytest
import torch

from test_api import TINY
from test_torch_config import to_port
from ttts_tpu.api import TextToSpeech as JaxTTS
from ttts_tpu.models.quantize import RVQState
from ttts_tpu_torch import porting
from ttts_tpu_torch.api import TextToSpeech, code_bucket

TEXT = "ni3 hao3 shi4 jie4"
MAX_GEN = 32
SEED = 0


class JaxDraws:
    """The draws JAX's tts makes from jax.random.key(seed)."""

    def __init__(self, seed):
        self.k1, self.k2 = jax.random.split(jax.random.key(seed))

    def gumbel(self, shape):
        steps, b, v = shape
        return torch.from_numpy(np.stack([np.asarray(jax.random.gumbel(k, (b, v)))
                                          for k in jax.random.split(self.k1, steps)]))

    def normal(self, shape):
        return torch.from_numpy(np.array(jax.random.normal(self.k2, shape)))


def make_pair():
    """JAX TINY TextToSpeech (every stage, a random codebook) and the port on
    the CPU with the same weights."""
    jtts = JaxTTS(TINY, seed=0)
    codec = dict(jtts.params["codec"])
    st = codec["codebook"]["quantizer"]["state"]
    embed = 0.3 * jax.random.normal(jax.random.key(9), st.embed.shape)
    codec["codebook"] = {"quantizer": {"state": RVQState(
        embed=embed, embed_avg=embed, cluster_size=st.cluster_size, inited=st.inited)}}
    jtts.set_params("codec", codec)
    tts = TextToSpeech(to_port(TINY), device="cpu", seed=1)
    for stage, variables in jtts.params.items():
        tts.set_params(stage, porting.STATE_DICT_FNS[stage](variables))
    return jtts, tts


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def make_voice():
    rng = np.random.default_rng(0)
    t = np.arange(44100) / 44100
    return (0.3 * np.sin(2 * np.pi * 180 * t) + 0.05 * rng.standard_normal(t.size)
            ).astype(np.float32)


@pytest.fixture(scope="module")
def voice():
    return make_voice()


def test_prompt_codes_equal(pair, voice):
    jtts, tts = pair
    want_codes, want_mel = jtts.get_conditioning(voice, 44100)
    codes, mel = tts.get_conditioning(voice, 44100)
    assert len(np.unique(np.asarray(want_codes))) > 1
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_codes))
    # compared as linear magnitudes: in the near-silent bins above the
    # resampler's cutoff, the log amplifies f32 FFT rounding to ~1e-2
    np.testing.assert_allclose(np.exp(mel.numpy()), np.exp(np.asarray(want_mel)),
                               atol=1e-4, rtol=0)


def _jax_draw(jtts, voice, k):
    """The candidates JAX's tts draws (its decode replayed with the same key
    split), its CLVP winner and the winner's code length."""
    ids = np.asarray(jtts.tok.encode(TEXT), np.int32)
    text_ids = np.pad(ids, (0, -len(ids) % 16))[None]
    prompt, _ = jtts.get_conditioning(voice, 44100)
    prompt = np.pad(np.asarray(prompt), ((0, 0), (0, -prompt.shape[1] % 16)))
    k1, _ = jax.random.split(jax.random.key(SEED))
    jcodes = np.asarray(jtts._gpt_sample(text_ids, prompt, k1, MAX_GEN, k))
    best = int(np.argmax(np.asarray(jtts._clvp_rank(text_ids, jcodes)))) if k > 1 else 0
    stops = np.where(jcodes[best] == TINY.gpt.stop_mel_token)[0]
    return jcodes, best, max(int(stops[0]) if len(stops) else MAX_GEN, 1)


def _check_tts(pair, voice, preset, k):
    jtts, tts = pair
    want = jtts.tts(TEXT, voice, 44100, preset=preset, max_generate_length=MAX_GEN, seed=SEED)
    jcodes, best, code_len = _jax_draw(jtts, voice, k)
    got = tts.tts(TEXT, voice, 44100, preset=preset, max_generate_length=MAX_GEN,
                  draws=JaxDraws(SEED))
    assert jcodes.shape == (k, MAX_GEN) and len(np.unique(jcodes)) > k
    np.testing.assert_array_equal(tts.last_codes, jcodes)
    assert tts.last_best == [best] and tts.last_code_lens == [code_len]
    hop = TINY.vocos.hop_length
    assert got.shape == want.shape == (min(code_len * 4, code_bucket(code_len, MAX_GEN) * 4 - 1)
                                       * hop,)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)


def test_tts_matches_jax(pair, voice):
    _check_tts(pair, voice, "ultra_fast", 1)


def test_tts_fast_matches_jax(pair, voice):
    """k = 4 candidates, all equal to JAX's, the same CLVP winner."""
    _check_tts(pair, voice, "fast", 4)


def test_fast_is_the_default(pair, voice):
    """tts defaults to preset "fast", as the JAX package's does: 4 candidates."""
    _, tts = pair
    tts.tts(TEXT, voice, 44100, max_generate_length=4)
    assert tts.last_codes.shape == (4, 4) and len(tts.last_best) == 1


def test_default_device_is_the_card():
    """TextToSpeech() targets the card; with none it fails instead of
    quietly running on the CPU."""
    if torch.cuda.is_available():
        assert TextToSpeech(to_port(TINY)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TextToSpeech(to_port(TINY))
