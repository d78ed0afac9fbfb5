"""PyTorch port parity of batched streams: TextToSpeech.tts_batch of two
texts against the JAX package's at presets "ultra_fast" and "fast" (JAX's
draws injected, as in tests/test_torch_slice.py), and tts_batch_many equal to
serial tts_batch calls with seeds seed + i (tests/test_api_batch.py:57-77).

Contract: each waveform within 5e-4 of JAX's (the golden snapshot's band);
tts_batch_many bit-identical to the serial calls."""

import numpy as np
import pytest

from test_torch_slice import MAX_GEN, JaxDraws, make_pair, make_voice

TEXTS = ["ni3 hao3", "shi4 jie4 hao3 jin1 tian1"]


@pytest.fixture(scope="module")
def pair():
    return make_pair()


@pytest.fixture(scope="module")
def voice():
    return make_voice()


@pytest.mark.parametrize("preset,k", [("ultra_fast", 1), ("fast", 4)])
def test_tts_batch_matches_jax(pair, voice, preset, k):
    jtts, tts = pair
    want = jtts.tts_batch(TEXTS, voice, 44100, preset=preset, max_generate_length=MAX_GEN,
                          seed=3)
    got = tts.tts_batch(TEXTS, voice, 44100, preset=preset, max_generate_length=MAX_GEN,
                        draws=JaxDraws(3))
    assert tts.last_codes.shape == (len(TEXTS) * k, MAX_GEN)
    assert [b // k for b in tts.last_best] == list(range(len(TEXTS)))
    assert len(got) == len(want) == len(TEXTS)
    hop = jtts.cfg.vocos.hop_length
    for g, w, cl in zip(got, want, tts.last_code_lens):
        assert g.shape == w.shape == (min(cl * 4 * hop, g.shape[0]),) and g.shape[0] > 0
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, atol=5e-4, rtol=0)


def test_tts_batch_many_equals_serial(pair, voice):
    _, tts = pair
    batches = [TEXTS, ["jin1 tian1 tian1 qi4"]]
    many = tts.tts_batch_many(batches, voice, 44100, max_generate_length=MAX_GEN, seed=7)
    assert [len(m) for m in many] == [2, 1]
    for i, texts in enumerate(batches):
        serial = tts.tts_batch(texts, voice, 44100, max_generate_length=MAX_GEN, seed=7 + i)
        for a, b in zip(many[i], serial):
            np.testing.assert_array_equal(a, b)


def test_tts_batch_many_conditions_once(pair, voice, monkeypatch):
    """tts_batch_many runs the voice's conditioning (the codec extract) once
    per call, not per batch, with no cache key, and its waveforms equal the
    serial per-batch tts_batch calls, which condition each time."""
    _, tts = pair
    calls = []
    extract = tts.codec.extract_code

    def counting(*args):
        calls.append(1)
        return extract(*args)

    monkeypatch.setattr(tts.codec, "extract_code", counting)
    batches = [["ni3 hao3"], ["jin1 tian1"], ["shi4 jie4"]]
    many = tts.tts_batch_many(batches, voice, 44100, preset="ultra_fast",
                              max_generate_length=MAX_GEN, seed=2)
    assert len(calls) == 1
    for i, texts in enumerate(batches):
        serial = tts.tts_batch(texts, voice, 44100, preset="ultra_fast",
                               max_generate_length=MAX_GEN, seed=2 + i)
        for a, b in zip(many[i], serial):
            np.testing.assert_array_equal(a, b)
    assert len(calls) == 1 + len(batches)
