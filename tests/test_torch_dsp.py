"""PyTorch port parity: resample, STFT/ISTFT and mel spectrograms
(ttts_tpu_torch/ops against ttts_tpu/ops) on the CPU, in f32.

Tolerance 1e-4 absolute: both sides run f32 FFTs and convolutions of the
same numpy-built filters; they differ only in summation order."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ttts_tpu_torch.ops.mel as tmel
import ttts_tpu_torch.ops.resample as tres
import ttts_tpu_torch.ops.stft as tstft

# ttts_tpu.ops re-exports functions under its submodules' names
jmel = importlib.import_module("ttts_tpu.ops.mel")
jres = importlib.import_module("ttts_tpu.ops.resample")
jstft = importlib.import_module("ttts_tpu.ops.stft")

ATOL = 1e-4


def _wav(seed, n):
    return (np.random.default_rng(seed).standard_normal((1, n)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("new_sr", [32000, 24000])
def test_resample_from_44k(new_sr):
    x = _wav(0, 44100)
    want = np.asarray(jres.resample(jnp.asarray(x), 44100, new_sr))
    got = tres.resample(torch.from_numpy(x), 44100, new_sr).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("n_fft,hop", [(2048, 640), (1024, 640)])
def test_vits_spectrogram(n_fft, hop):
    x = _wav(1, 32000)
    want = np.asarray(jmel.vits_spectrogram(jnp.asarray(x), n_fft, hop, n_fft))
    got = tmel.vits_spectrogram(torch.from_numpy(x), n_fft, hop, n_fft).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("n_fft", [1024, 256])
def test_acoustic_mel_spectrogram(n_fft):
    x = _wav(2, 24000)
    want = np.asarray(jmel.acoustic_mel_spectrogram(jnp.asarray(x), 24000, n_fft, 256, 100))
    got = tmel.acoustic_mel_spectrogram(torch.from_numpy(x), 24000, n_fft, 256, 100).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_mel_filterbank_is_the_same_table():
    for args in ((24000, 1024, 100, 0.0, 12000.0, "htk", None),
                 (32000, 2048, 128, 0.0, None, "slaney", "slaney")):
        np.testing.assert_array_equal(tmel.mel_filterbank(*args), jmel.mel_filterbank(*args))


@pytest.mark.parametrize("padding", ["center", "same"])
def test_istft(padding):
    rng = np.random.default_rng(3)
    spec = (rng.standard_normal((2, 513, 12))
            + 1j * rng.standard_normal((2, 513, 12))).astype(np.complex64)
    want = np.asarray(jstft.istft(jnp.asarray(spec), 1024, 256, 1024, padding=padding))
    got = tstft.istft(torch.from_numpy(spec), 1024, 256, 1024, padding=padding).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_stft_center_matches():
    x = _wav(4, 4000)
    want = np.asarray(jstft.stft(jnp.asarray(x), 256, 64, center=True))
    got = tstft.stft(torch.from_numpy(x), 256, 64, center=True).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
