"""Polyphase windowed-sinc resampling (torchaudio.functional.resample
semantics), port of ttts_tpu/ops/resample.py: the same numpy kernel bank,
applied as one strided conv1d."""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=32)
def _sinc_kernel(orig_freq: int, new_freq: int, lowpass_filter_width: int = 6,
                 rolloff: float = 0.99) -> tuple[np.ndarray, int]:
    """Polyphase kernel bank (new_freq, 2*width + orig_freq) and width."""
    base_freq = min(orig_freq, new_freq) / 2.0 * rolloff
    width = math.ceil(lowpass_filter_width * orig_freq / base_freq)
    idx = np.arange(-width, width + orig_freq, dtype=np.float64)[None, :] / orig_freq
    t = np.arange(0, -new_freq, -1, dtype=np.float64)[:, None] / new_freq + idx
    t = t * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * math.pi / lowpass_filter_width / 2.0) ** 2  # hann
    t = t * math.pi
    scale = base_freq / orig_freq
    kernel = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernel = kernel * window * scale
    return kernel.astype(np.float32), width


def resample(x: torch.Tensor, orig_freq: int, new_freq: int,
             lowpass_filter_width: int = 6, rolloff: float = 0.99) -> torch.Tensor:
    """Resample (..., T) from orig_freq to new_freq."""
    if orig_freq == new_freq:
        return x
    g = math.gcd(int(orig_freq), int(new_freq))
    o, n = int(orig_freq) // g, int(new_freq) // g
    kernel_np, width = _sinc_kernel(o, n, lowpass_filter_width, rolloff)
    kernel = torch.from_numpy(kernel_np).to(x.device)[:, None, :]  # (n, 1, kw)
    lead, length = x.shape[:-1], x.shape[-1]
    xb = F.pad(x.reshape(-1, 1, length), (width, width + o))
    y = F.conv1d(xb, kernel, stride=o)  # (B, n, frames): one phase per channel
    y = y.transpose(1, 2).reshape(xb.shape[0], -1)
    target = int(math.ceil(n * length / o))
    return y[:, :target].reshape(*lead, target)
