"""MDCT / IMDCT, port of ttts_tpu/ops/mdct.py (reference ttts/vocoder/
spectral_ops.py:78-190): an FFT-based modified DCT with a cosine window and
50% overlap-add, for the Vocos IMDCT heads. Framing and overlap-add are
ops/stft's; the twiddle factors are built in float64 and applied in
complex64."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ttts_tpu_torch.ops.stft import frame, overlap_add


def _cosine_window(n: int, device) -> torch.Tensor:
    return torch.tensor(np.sin(np.pi / n * (np.arange(n) + 0.5)), dtype=torch.float32,
                        device=device)


def _twiddle(phase: np.ndarray, device) -> torch.Tensor:
    """exp(1j * phase) as complex64."""
    return torch.tensor(np.exp(1j * phase), dtype=torch.complex64, device=device)


def _pad(frame_len: int, padding: str) -> int:
    if padding == "center":
        return frame_len // 2
    if padding == "same":
        return frame_len // 4
    raise ValueError("padding must be 'center' or 'same'")


def mdct(audio: torch.Tensor, frame_len: int, padding: str = "same") -> torch.Tensor:
    """audio (B, T) → coefficients (B, L, frame_len // 2)."""
    n = frame_len // 2
    n0 = (n + 1) / 2
    pad = _pad(frame_len, padding)
    x = frame(F.pad(audio, (pad, pad)), frame_len, n) * _cosine_window(frame_len, audio.device)
    pre = _twiddle(-np.pi * np.arange(frame_len) / frame_len, audio.device)
    post = _twiddle(-np.pi * n0 * (np.arange(n) + 0.5) / n, audio.device)
    spec = torch.fft.fft(x * pre, dim=-1)[..., :n]
    return (spec * post).real * (math.sqrt(1 / n) * math.sqrt(2))


def imdct(coeffs: torch.Tensor, frame_len: int, padding: str = "same") -> torch.Tensor:
    """coefficients (B, L, N) → audio (B, (L + 1) * N - 2 * pad), trimmed by
    frame_len // 2 ("center") or frame_len // 4 ("same") at each end."""
    _, l, n = coeffs.shape
    n0 = (n + 1) / 2
    y = torch.cat([coeffs, -coeffs.flip(-1)], dim=-1).to(torch.complex64)
    pre = _twiddle(np.pi * n0 * np.arange(2 * n) / n, coeffs.device)
    post = _twiddle(np.pi * (np.arange(2 * n) + n0) / (2 * n), coeffs.device)
    y = (torch.fft.ifft(y * pre, dim=-1) * post).real * (math.sqrt(n) * math.sqrt(2))
    audio = overlap_add(y * _cosine_window(frame_len, coeffs.device), n)
    pad = _pad(frame_len, padding)
    return audio[:, pad: (l + 1) * n - pad]
