"""Spectrograms of the voice's conditioning, port of ttts_tpu/ops/mel.py:

1. VITS codec path: 32 kHz linear spectrogram, reflect pad (n_fft-hop)/2,
   center=False, sqrt(power + 1e-6) (`vits_spectrogram`).
2. Acoustic 24 kHz / 100-bin mel (torchaudio MelSpectrogram, center=True,
   power=1, htk scale, no norm) + safe_log.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from portbench.reference.stft import reflect_pad_last, stft


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
