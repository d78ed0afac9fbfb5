"""Mel spectrograms, port of ttts_tpu/ops/mel.py (the two conventions of the
serving and codec training paths):

1. VITS codec path: 32 kHz linear spectrogram, reflect pad (n_fft-hop)/2,
   center=False, sqrt(power + 1e-6); the codec GAN's loss mel on top of it
   (`vits_mel_spectrogram`: a librosa slaney mel matmul, then log(clamp(x,
   1e-5))).
2. Acoustic 24 kHz / 100-bin mel (torchaudio MelSpectrogram, center=True,
   power=1, htk scale, no norm) + safe_log.
3. Tortoise-v1 22.05 kHz / 80-bin mel (`tacotron_mel_spectrogram`:
   torchaudio MelSpectrogram power=2, htk scale, slaney norm, fmax 8000,
   then log(clamp(x, 1e-5)), DiscreteVAE's input) and its min-max [-1, 1]
   normalisation.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ttts_tpu_torch.ops.stft import reflect_pad_last, stft


def _hz_to_mel(f, scale: str):
    f = np.asarray(f, dtype=np.float64)
    if scale == "htk":
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    f / f_sp)


def _mel_to_hz(m, scale: str):
    m = np.asarray(m, dtype=np.float64)
    if scale == "htk":
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    f_sp * m)


@functools.lru_cache(maxsize=32)
def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: Optional[float] = None, scale: str = "slaney",
                   norm: Optional[str] = "slaney") -> np.ndarray:
    """(n_mels, n_fft//2+1) triangular filterbank. slaney/slaney = librosa
    defaults; htk/None = torchaudio melscale_fbanks defaults."""
    if fmax is None:
        fmax = sample_rate / 2.0
    fftfreqs = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    mel_pts = np.linspace(_hz_to_mel(fmin, scale), _hz_to_mel(fmax, scale), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts, scale)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
        weights = weights * enorm[:, None]
    return weights.astype(np.float32)


def safe_log(x: torch.Tensor, clip_val: float = 1e-7) -> torch.Tensor:
    """log(clip(x, min=1e-7))."""
    return torch.log(x.clamp_min(clip_val))


def vits_spectrogram(y: torch.Tensor, n_fft: int, hop_length: int,
                     win_length: int) -> torch.Tensor:
    """(B, T) → (B, n_fft//2+1, frames) linear magnitude."""
    y = reflect_pad_last(y, int((n_fft - hop_length) / 2))
    spec = stft(y, n_fft, hop_length, win_length, center=False)
    return torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-6)


def dynamic_range_compression(x: torch.Tensor, clip_val: float = 1e-5,
                              C: float = 1.0) -> torch.Tensor:
    """log(clamp(x, min=1e-5) * C) (ttts/utils/data_utils.py:21)."""
    return torch.log(x.clamp_min(clip_val) * C)


def spec_to_mel(spec: torch.Tensor, n_fft: int, num_mels: int, sampling_rate: int,
                fmin: float = 0.0, fmax: Optional[float] = None) -> torch.Tensor:
    """(..., n_fft//2+1, T) linear spectrogram → (..., num_mels, T) log mel:
    the slaney filterbank, then dynamic_range_compression
    (ttts/utils/data_utils.py:90-103)."""
    basis = torch.from_numpy(mel_filterbank(sampling_rate, n_fft, num_mels, fmin, fmax,
                                            scale="slaney", norm="slaney"))
    return dynamic_range_compression(
        torch.einsum("mf,...ft->...mt", basis.to(spec.device), spec))


def vits_mel_spectrogram(y: torch.Tensor, n_fft: int, num_mels: int, sampling_rate: int,
                         hop_length: int, win_length: int, fmin: float = 0.0,
                         fmax: Optional[float] = None) -> torch.Tensor:
    """(B, T) → (B, num_mels, frames): the codec GAN's loss mel
    (mel_spectrogram_torch, ttts/utils/data_utils.py:106-155)."""
    spec = vits_spectrogram(y, n_fft, hop_length, win_length)
    return spec_to_mel(spec, n_fft, num_mels, sampling_rate, fmin, fmax)


def acoustic_mel_spectrogram(audio: torch.Tensor, sample_rate: int = 24000,
                             n_fft: int = 1024, hop_length: int = 256,
                             n_mels: int = 100, padding: str = "center") -> torch.Tensor:
    """(B, T) → (B, n_mels, frames) log-mel (MelSpectrogramFeatures)."""
    if padding == "same":
        audio = reflect_pad_last(audio, (n_fft - hop_length) // 2)
    spec = stft(audio, n_fft, hop_length, n_fft, center=padding != "same")
    basis = torch.from_numpy(mel_filterbank(sample_rate, n_fft, n_mels, 0.0,
                                            sample_rate / 2.0, scale="htk", norm=None))
    mel = torch.einsum("mf,...ft->...mt", basis.to(audio.device), spec.abs())
    return safe_log(mel)


TACOTRON_MEL_MAX = 5.5451774444795624753378569716654
TACOTRON_MEL_MIN = -16.118095650958319788125940182791


def tacotron_mel_spectrogram(audio: torch.Tensor, sample_rate: int = 22050,
                             n_fft: int = 1024, hop_length: int = 256, win_length: int = 1024,
                             n_mels: int = 80, fmin: float = 0.0, fmax: float = 8000.0,
                             mel_norms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, T) → (B, n_mels, frames), the Tortoise-v1 mel (ttts/utils/utils.py
    TorchMelSpectrogram:387-425): power spectrum of a centred STFT, the htk
    mel scale with slaney norm in an f32 product, log(clamp(x, 1e-5)), each
    bin divided by `mel_norms` (n_mels,) when given."""
    spec = stft(audio, n_fft, hop_length, win_length, center=True)
    power = spec.real ** 2 + spec.imag ** 2
    basis = torch.from_numpy(mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax,
                                            scale="htk", norm="slaney"))
    mel = torch.log(torch.einsum("mf,...ft->...mt", basis.to(audio.device), power)
                    .clamp_min(1e-5))
    if mel_norms is not None:
        mel = mel / mel_norms.to(mel.device)[None, :, None]
    return mel


def normalize_tacotron_mel_minmax(mel: torch.Tensor) -> torch.Tensor:
    """Min-max to [-1, 1] (diffusion_util.py:42-43, the v1 convention)."""
    return 2.0 * ((mel - TACOTRON_MEL_MIN) / (TACOTRON_MEL_MAX - TACOTRON_MEL_MIN)) - 1.0


def denormalize_tacotron_mel_minmax(norm_mel: torch.Tensor) -> torch.Tensor:
    return ((norm_mel + 1.0) / 2.0) * (TACOTRON_MEL_MAX - TACOTRON_MEL_MIN) + TACOTRON_MEL_MIN
