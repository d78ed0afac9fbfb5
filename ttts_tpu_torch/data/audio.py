"""Host audio IO, port of ttts_tpu/data/audio.py: WAV decode to mono f32,
PCM16 writing, polyphase sinc resampling and energy-VAD silence splitting
(ttts/prepare/vad_process.py:6-31: min_silence 500 ms, -40 dB).

Each function takes the port's own copy of the JAX package's native
library (ttts_tpu_torch/native/audio_io.cc, through ctypes) where it builds
(at first use, with `make`, into the git-ignored libttts_audio.so), as the
JAX package does, and otherwise the same fallbacks as JAX: the standard
library's `wave` for PCM16 / PCM32, ops/resample.py for resampling, and
numpy 10 ms energy windows for the VAD. These are host IO paths; nothing
here runs on the card.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import wave
from typing import List, Optional, Tuple

import numpy as np
import torch

from ttts_tpu_torch.ops.resample import resample

_LIB_PATH = pathlib.Path(__file__).resolve().parent.parent / "native" / "libttts_audio.so"
_lib = None
_P64 = ctypes.POINTER(ctypes.c_int64)
_PF = ctypes.POINTER(ctypes.c_float)


class WavInfo(ctypes.Structure):
    _fields_ = [("sample_rate", ctypes.c_int32), ("channels", ctypes.c_int32),
                ("frames", ctypes.c_int64)]


_SIGNATURES = {
    "wav_info": ((ctypes.c_char_p, ctypes.POINTER(WavInfo)), ctypes.c_int),
    "wav_decode_mono": ((ctypes.c_char_p, _PF), ctypes.c_int),
    "wav_write_pcm16": ((ctypes.c_char_p, _PF, ctypes.c_int64, ctypes.c_int32), ctypes.c_int),
    "resample_out_len": ((ctypes.c_int64, ctypes.c_int32, ctypes.c_int32), ctypes.c_int64),
    "resample_sinc": ((_PF, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, _PF), ctypes.c_int),
    "vad_split": ((_PF, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_float,
                   ctypes.c_int32, _P64, _P64, ctypes.c_int32), ctypes.c_int),
}


def _native():
    """The native library, built on first use; None where it does not build."""
    global _lib
    if _lib is None and not _LIB_PATH.exists():
        try:
            subprocess.run(["make", "-C", str(_LIB_PATH.parent)], check=True,
                           capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
    if _lib is None and _LIB_PATH.exists():
        lib = ctypes.CDLL(str(_LIB_PATH))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        _lib = lib
    return _lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(_PF)


def load_wav(path: str | pathlib.Path, target_sr: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """WAV → (mono float32 in [-1, 1], sample rate), resampled to
    `target_sr` when given."""
    path = str(path)
    lib = _native()
    if lib is not None:
        info = WavInfo()
        if lib.wav_info(path.encode(), ctypes.byref(info)) == 0:
            out = np.empty(info.frames, np.float32)
            if lib.wav_decode_mono(path.encode(), _fptr(out)) == 0:
                sr = info.sample_rate
                if target_sr and sr != target_sr:
                    out, sr = resample_audio(out, sr, target_sr), target_sr
                return out, sr
    with wave.open(path, "rb") as w:
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
        data, sr = resample_audio(data, sr, target_sr), target_sr
    return data, sr


def wav_frames(path: str | pathlib.Path, target_sr: Optional[int] = None) -> int:
    """The frame count from the WAV header alone (no decode), rescaled to
    `target_sr` when given, for the bucket sampler's length scan."""
    path = str(path)
    lib = _native()
    if lib is not None:
        info = WavInfo()
        if lib.wav_info(path.encode(), ctypes.byref(info)) == 0:
            n, sr = int(info.frames), int(info.sample_rate)
            return n if not target_sr else int(n * target_sr / sr)
    with wave.open(path, "rb") as w:
        n, sr = w.getnframes(), w.getframerate()
    return n if not target_sr else int(n * target_sr / sr)


def resample_audio(x: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """Polyphase sinc resampling on the host (torchaudio semantics)."""
    if orig_sr == new_sr:
        return x
    x = np.ascontiguousarray(x, np.float32)
    lib = _native()
    if lib is not None:
        out = np.empty(lib.resample_out_len(len(x), orig_sr, new_sr), np.float32)
        if lib.resample_sinc(_fptr(x), len(x), orig_sr, new_sr, _fptr(out)) == 0:
            return out
    return resample(torch.from_numpy(x)[None], orig_sr, new_sr)[0].numpy()


def save_wav(path: str | pathlib.Path, data: np.ndarray, sample_rate: int) -> None:
    """Mono float waveform → PCM16 WAV, clipped to [-1, 1]."""
    data = np.ascontiguousarray(np.clip(data, -1, 1), np.float32)
    lib = _native()
    if lib is not None and lib.wav_write_pcm16(str(path).encode(), _fptr(data), len(data),
                                               sample_rate) == 0:
        return
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes((data * 32767).astype(np.int16).tobytes())


def vad_split(x: np.ndarray, sample_rate: int, min_silence_ms: int = 500,
              silence_thresh_db: float = -40.0, keep_silence_ms: int = 100,
              max_segments: int = 4096) -> List[Tuple[int, int]]:
    """Energy-based silence splitting over 10 ms windows (pydub
    split_on_silence semantics) → [(start, end)] sample ranges, each padded
    by `keep_silence_ms`."""
    x = np.ascontiguousarray(x, np.float32)
    lib = _native()
    if lib is not None:
        starts, ends = np.zeros(max_segments, np.int64), np.zeros(max_segments, np.int64)
        n = lib.vad_split(_fptr(x), len(x), sample_rate, min_silence_ms,
                          silence_thresh_db, keep_silence_ms, starts.ctypes.data_as(_P64),
                          ends.ctypes.data_as(_P64), max_segments)
        return [(int(starts[i]), int(ends[i])) for i in range(n)]
    win = sample_rate // 100
    n_win = len(x) // win
    e = (x[: n_win * win].reshape(n_win, win) ** 2).mean(axis=1)
    silent = e < 10 ** (silence_thresh_db / 10)
    segs = []
    start, sil = None, 0
    min_sil = max(1, min_silence_ms // 10)
    keep = keep_silence_ms * sample_rate // 1000
    for w in range(n_win + 1):
        if w < n_win and not silent[w]:
            if start is None:
                start = w * win
            sil = 0
            continue
        sil += 1
        if start is not None and (sil >= min_sil or w == n_win):
            end = (w - sil + 1) * win
            segs.append((max(0, start - keep), min(len(x), end + keep)))
            start = None
    return segs
