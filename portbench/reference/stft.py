"""STFT / ISTFT primitives, port of ttts_tpu/ops/stft.py.

  - ``stft``: torch.stft semantics with center=False (caller pads) or
    center=True, onesided, not normalized.
  - ``istft``: the Vocos overlap-add ISTFT with a window-square envelope and
    "same" or "center" trimming.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Periodic Hann window (torch.hann_window(periodic=True)), built in f64."""
    n = np.arange(win_length)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    return torch.tensor(w, dtype=dtype, device=device)


def frame(x: torch.Tensor, frame_length: int, hop_length: int) -> torch.Tensor:
    """(..., T) → (..., n_frames, frame_length), n_frames = 1 + (T-L)//hop."""
    return x.unfold(-1, frame_length, hop_length)


def reflect_pad_last(x: torch.Tensor, pad: int) -> torch.Tensor:
    if pad == 0:
        return x
    lead = x.shape[:-1]
    y = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect")
    return y.reshape(*lead, y.shape[-1])


def stft(y: torch.Tensor, n_fft: int, hop_length: int,
         win_length: Optional[int] = None, window: Optional[torch.Tensor] = None,
         center: bool = False) -> torch.Tensor:
    """Complex STFT of y (..., T) → (..., n_fft//2+1, n_frames)."""
    win_length = win_length or n_fft
    if window is None:
        window = hann_window(win_length, dtype=y.dtype, device=y.device)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = F.pad(window, (lpad, n_fft - win_length - lpad))
    if center:
        y = reflect_pad_last(y, n_fft // 2)
    frames = frame(y, n_fft, hop_length) * window
    return torch.fft.rfft(frames, n=n_fft, dim=-1).transpose(-1, -2)


def overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """(B, T, W) frames → (B, (T-1)*hop + W), summing the overlaps."""
    b, t, w = frames.shape
    out_len = (t - 1) * hop_length + w
    out = F.fold(frames.transpose(1, 2), output_size=(1, out_len),
                 kernel_size=(1, w), stride=(1, hop_length))
    return out.reshape(b, out_len)


def istft(spec: torch.Tensor, n_fft: int, hop_length: int, win_length: int,
          padding: str = "same") -> torch.Tensor:
    """Inverse STFT of complex spec (B, n_fft//2+1, T) → (B, L).
    padding="same" trims (win - hop)//2 from both ends, "center" n_fft//2."""
    window = hann_window(win_length, device=spec.device)
    t = spec.shape[-1]
    ifft = torch.fft.irfft(spec, n=n_fft, dim=1) * window[None, :, None]
    output_size = (t - 1) * hop_length + win_length
    y = overlap_add(ifft.transpose(1, 2), hop_length)
    n = np.arange(win_length)
    win_sq = (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)) ** 2
    env = np.zeros((output_size,), np.float64)
    for j in range(t):
        env[j * hop_length: j * hop_length + win_length] += win_sq
    if padding == "same":
        pad = (win_length - hop_length) // 2
    elif padding == "center":
        pad = n_fft // 2
    else:
        raise ValueError("padding must be 'same' or 'center'")
    env_t = torch.tensor(env[pad: output_size - pad], dtype=torch.float32,
                         device=spec.device)
    return y[:, pad: output_size - pad] / env_t.clamp_min(1e-11)
