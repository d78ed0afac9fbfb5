"""WAV read and write, the port's own copy of the standard-library path of
ttts_tpu/data/audio.py (`load_wav`, `save_wav`, `wav_frames`): PCM16 and
PCM32 through `wave`, channels averaged to mono, resampled by
ops/resample.py. The JAX package's native reader is not ported."""

from __future__ import annotations

import pathlib
import wave
from typing import Optional, Tuple

import numpy as np
import torch

from ttts_tpu_torch.ops.resample import resample


def load_wav(path: str | pathlib.Path, target_sr: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """WAV → (mono float32 in [-1, 1], sample rate), resampled to
    `target_sr` when given."""
    with wave.open(str(path), "rb") as w:
        sr, n, ch, sw = w.getframerate(), w.getnframes(), w.getnchannels(), w.getsampwidth()
        raw = w.readframes(n)
    if sw == 2:
        data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif sw == 4:
        data = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"{path}: unsupported sample width {sw} (PCM16 or PCM32)")
    data = data.reshape(-1, ch).mean(axis=1)
    if target_sr and sr != target_sr:
        data = resample(torch.from_numpy(data), sr, target_sr).numpy()
        sr = target_sr
    return data, sr


def wav_frames(path: str | pathlib.Path, target_sr: Optional[int] = None) -> int:
    """The frame count from the WAV header alone (no decode), rescaled to
    `target_sr` when given, for the bucket sampler's length scan."""
    with wave.open(str(path), "rb") as w:
        n, sr = w.getnframes(), w.getframerate()
    return n if not target_sr else int(n * target_sr / sr)


def save_wav(path: str | pathlib.Path, data: np.ndarray, sample_rate: int) -> None:
    """Mono float waveform → PCM16 WAV, clipped to [-1, 1]."""
    data = np.clip(np.asarray(data, np.float32), -1, 1)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes((data * 32767).astype(np.int16).tobytes())
