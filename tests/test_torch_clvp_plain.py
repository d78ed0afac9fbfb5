"""PyTorch port parity: the plain-Transformer CLVP (use_xformers=False, the
reference v2 trainer's flavour) against ttts_tpu's on the CPU, in f32,
weights carried through ttts_tpu_torch.porting under the reference's key
names (ttts_tpu.models.porting.port_clvp_state reads them back), and
TextToSpeech serving with it and the UniPC sampler on TINY.

Contract: similarities within 1e-4 relative to the largest |similarity|
(f32, summation order only), the same rerank winner over a candidate set
whose margin exceeds that; the key map a bit-exact round trip."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_api import TINY
from test_torch_codec_synth import seeded_variables
from test_torch_config import to_port
from ttts_tpu.models import porting as jporting
from ttts_tpu.models.clvp import CLVP as JaxCLVP
from ttts_tpu_torch import porting
from ttts_tpu_torch.api import TextToSpeech
from ttts_tpu_torch.models.clvp import CLVP

RTOL = 1e-4
CFG = dataclasses.replace(TINY.clvp, use_xformers=False, text_seq_len=24, dim_text=64,
                          dim_speech=64, text_heads=4, speech_heads=4, text_enc_depth=2,
                          speech_enc_depth=2)


@pytest.fixture(scope="module")
def clvp():
    model = JaxCLVP(CFG)
    variables = seeded_variables(lambda: model.init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32), jnp.zeros((1, 16), jnp.int32)))
    port = CLVP(to_port(CFG)).eval()
    port.load_state_dict({k: torch.as_tensor(v) for k, v in
                          porting.clvp_state_dict(variables).items()})
    return model, jax.jit(model.apply), variables, port


def _tokens(seed, b=4, lt=16, ls=40):
    rng = np.random.default_rng(seed)
    return (rng.integers(1, CFG.num_text_tokens, (b, lt)).astype(np.int32),
            rng.integers(0, 1024, (b, ls)).astype(np.int32))


def _assert_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * np.abs(want).max())


def _port(port, *arrays):
    with torch.no_grad():
        return port(*(torch.from_numpy(a).long() if a.dtype != bool else torch.from_numpy(a)
                      for a in arrays)).numpy()


def test_similarities(clvp):
    _, apply, variables, port = clvp
    text, speech = _tokens(0)
    want = np.asarray(apply(variables, jnp.asarray(text), jnp.asarray(speech)))
    got = _port(port, text, speech)
    assert got.shape == (4,)
    _assert_close(got, want)


def test_masked_similarities(clvp):
    """With masks: keys masked with -finfo.max and masked mean pooling."""
    _, apply, variables, port = clvp
    text, speech = _tokens(1)
    tmask = np.arange(16)[None] < np.asarray([16, 9, 12, 3])[:, None]
    vmask = np.arange(40)[None] < np.asarray([40, 17, 25, 31])[:, None]
    want = np.asarray(apply(variables, *map(jnp.asarray, (text, speech, tmask, vmask))))
    _assert_close(_port(port, text, speech, tmask, vmask), want)


def test_rerank_winner(clvp):
    """One text against 4 candidate code sequences: the same argmax, with a
    margin wider than the tolerance."""
    _, apply, variables, port = clvp
    text, speech = _tokens(2)
    text = np.repeat(text[:1], 4, axis=0)
    want = np.asarray(apply(variables, jnp.asarray(text), jnp.asarray(speech)))
    got = _port(port, text, speech)
    top2 = np.sort(want)[-2:]
    assert top2[1] - top2[0] > 10 * RTOL * np.abs(want).max()
    assert int(np.argmax(got)) == int(np.argmax(want))


def test_converter_round_trip(clvp):
    _, _, variables, port = clvp
    sd = porting.clvp_state_dict(variables)
    assert set(sd) == set(port.state_dict())
    assert "text_pos_emb.weight" in sd and "text_transformer.layers.layers.1.0.scale" in sd
    back = jporting.port_clvp_state(sd, CFG.text_enc_depth, CFG.speech_enc_depth)
    want = jax.tree_util.tree_map(np.asarray, variables["params"])
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, want)


def test_overlong_text_raises(clvp):
    """A text longer than text_seq_len has no position row: JAX's broadcast
    fails, the port raises."""
    model, _, variables, port = clvp
    text, speech = _tokens(3, lt=CFG.text_seq_len + 1)
    with pytest.raises(Exception):
        model.apply(variables, jnp.asarray(text), jnp.asarray(speech))
    with pytest.raises(ValueError, match="text positions"):
        _port(port, text, speech)


def test_layer_scale_starts_at_a_tenth():
    port = CLVP(to_port(CFG))
    scales = [v for k, v in port.state_dict().items() if k.endswith(".scale")]
    assert len(scales) == 2 * (CFG.text_enc_depth + CFG.speech_enc_depth)
    assert all(torch.equal(s, torch.full((1, 1, 64), 0.1)) for s in scales)


def test_tts_serves_plain_clvp_and_unipc():
    """TextToSpeech on TINY with the plain CLVP and sampler "unipc": preset
    "fast" reranks 4 candidates with it and samples the tail with UniPC."""
    cfg = to_port(dataclasses.replace(
        TINY, clvp=dataclasses.replace(TINY.clvp, use_xformers=False),
        diffusion=dataclasses.replace(TINY.diffusion, sampler="unipc")))
    tts = TextToSpeech(cfg, device="cpu", seed=0)
    rng = np.random.default_rng(0)
    voice = (0.3 * np.sin(np.arange(44100) / 44100 * 2 * np.pi * 180)
             + 0.05 * rng.standard_normal(44100)).astype(np.float32)
    wav = tts.tts("ni3 hao3", voice, 44100, max_generate_length=16)
    assert tts.last_codes.shape == (4, 16) and len(tts.last_best) == 1
    assert wav.ndim == 1 and wav.size > 0 and np.isfinite(wav).all()
