"""The GPT and diffusion datasets, port of ttts_tpu/data/datasets.py:31-183:
padded numpy batches, with the reference's filters:
  - GptTtsDataset (ttts/gpt/dataset.py:30-63): pinyin → BPE text ids, `.vq`
    sidecar codes, drops text > 400 or codes > 600, and the wav lengths the
    model's mel-padding rewrite needs.
  - DiffusionDataset (ttts/diffusion/dataset.py:31-71): `.mel` + `.vq`
    sidecars; the reference mel is a random 1/3-2/3 split of the same
    utterance, capped at 200 frames, drawn from the dataset's numpy
    generator as the JAX package draws it; target mel cap 400 frames, 100
    codes.
  - VQGANDataset (ttts/vqvae/dataset.py:30-113): wav + text for the codec
    GAN; duration filter 0.65-54 s, wav → mono 32 kHz cut to whole hops and
    clipped to [-1, 1], pinyin → BPE; frames padded to a multiple of 8, text
    to 16 (ttts_tpu/data/datasets.py:184-228).
  - CLVPDataset (ttts/clvp/dataset.py; datasets.py:231-270): BPE text ids
    and the `.vq` sidecar's speech codes, both padded to multiples of 32.
  - PreprocessedMelDataset (ttts/classifier/dataset.py:13-58; datasets.py:
    273-335): clean (label 0) and noise (label 1) `.mel` sidecars, random-
    cropped or zero-padded to `pad_to` frames; the crop starts come from the
    dataset's numpy generator in __getitem__ order, so a loader repeats the
    JAX package's crops only with one worker.
Batches pad to multiples of `pad_to`, as the JAX package's do.
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import List, Optional, Sequence

import numpy as np

from ttts_tpu_torch.data.audio import load_wav
from ttts_tpu_torch.data.manifest import load_sidecar, read_manifest, sidecar_shape
from ttts_tpu_torch.text import VoiceBpeTokenizer, default_tokenizer, text_to_pinyin


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _pad_to(arr: np.ndarray, length: int, value=0):
    pad = length - arr.shape[0]
    if pad <= 0:
        return arr[:length]
    cfg = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, cfg, constant_values=value)


@dataclasses.dataclass
class GptExample:
    text_ids: np.ndarray
    codes: np.ndarray
    wav_length: int


class GptTtsDataset:
    """jsonl → (text ids, VQ codes, wav length)."""

    MAX_TEXT = 400
    MAX_CODES = 600

    def __init__(self, manifest_path: str, tokenizer: Optional[VoiceBpeTokenizer] = None,
                 sample_rate: int = 24000, code_samples: int = 1024):
        self.rows = read_manifest(manifest_path)
        self.tok = tokenizer or default_tokenizer()
        self.code_samples = code_samples

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, idx: int) -> Optional[GptExample]:
        row = self.rows[idx]
        try:
            text = text_to_pinyin(row["text"])
            ids = np.asarray(self.tok.encode(text), np.int32)
            codes = load_sidecar(row["path"], "vq")
            if codes is None:
                return None
            codes = np.asarray(codes, np.int32).reshape(-1)
            if len(ids) > self.MAX_TEXT or len(codes) > self.MAX_CODES:
                return None  # gpt/dataset.py:56
            return GptExample(ids, codes, int(len(codes) * self.code_samples))
        except Exception:
            return None  # per-sample fault tolerance (gpt/dataset.py:49-51)

    def lengths(self) -> List[int]:
        """Per-row VQ-code count from the sidecar header (no data load;
        -1 = sidecar missing → the bucket sampler drops the row, matching
        __getitem__ returning None). Feeds DistributedBucketSampler."""
        out = []
        for r in self.rows:
            shp = sidecar_shape(r["path"], "vq")
            out.append(int(np.prod(shp)) if shp else -1)
        return out

    def collate(self, examples: Sequence[Optional[GptExample]], pad_to: int = 32):
        """GptTtsCollater semantics (gpt/dataset.py:65-97) with bucket-rounded
        static shapes. Text pads with 0 (== stop_text_token); codes pad with 0
        and rely on the model's stop rewrite."""
        ex = [e for e in examples if e is not None]
        if not ex:
            return None
        lt = _round_up(max(len(e.text_ids) for e in ex), pad_to)
        lm = _round_up(max(len(e.codes) for e in ex), pad_to)
        return {
            "text": np.stack([_pad_to(e.text_ids, lt) for e in ex]),
            "text_lengths": np.asarray([len(e.text_ids) for e in ex], np.int32),
            "mel_codes": np.stack([_pad_to(e.codes, lm) for e in ex]),
            "wav_lengths": np.asarray([e.wav_length for e in ex], np.int32),
        }


class DiffusionDataset:
    MAX_MEL = 400
    MAX_CODES = 100
    MAX_REFER = 200

    def __init__(self, manifest_path: str, tokenizer: Optional[VoiceBpeTokenizer] = None,
                 rng: Optional[np.random.Generator] = None):
        self.rows = read_manifest(manifest_path)
        self.tok = tokenizer or default_tokenizer()
        self.rng = rng or np.random.default_rng(0)

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, idx: int) -> Optional[dict]:
        row = self.rows[idx]
        try:
            ids = np.asarray(self.tok.encode(text_to_pinyin(row["text"])), np.int32)
            mel = load_sidecar(row["path"], "mel")
            codes = load_sidecar(row["path"], "vq")
            if mel is None or codes is None:
                return None
            mel = np.asarray(mel, np.float32)
            if mel.ndim == 3:
                mel = mel[0]
            if mel.shape[0] < mel.shape[-1]:  # (100, T) → (T, 100)
                mel = mel.T
            codes = np.asarray(codes, np.int32).reshape(-1)
            # reference mel: random ⅓–⅔ split of the same utterance, ≤200
            t = mel.shape[0]
            split = int(self.rng.uniform(t / 3, 2 * t / 3))
            if self.rng.random() < 0.5:
                refer = mel[:split][-self.MAX_REFER:]
            else:
                refer = mel[split:][: self.MAX_REFER]
            mel = mel[: self.MAX_MEL]
            codes = codes[: self.MAX_CODES]
            return {
                "text": ids,
                "mel": mel,
                "refer": refer,
                "codes": codes,
                "wav_length": int(len(codes) * 1024),
            }
        except Exception:
            return None

    def lengths(self) -> List[int]:
        """Per-row mel-frame count (header-only scan, capped at MAX_MEL like
        __getitem__; -1 = missing). The frames axis is whichever sidecar dim
        isn't the 100-bin mel axis — same heuristic __getitem__ applies."""
        out = []
        for r in self.rows:
            shp = sidecar_shape(r["path"], "mel")
            out.append(min(max(shp), self.MAX_MEL) if shp else -1)
        return out

    def collate(self, examples, pad_to: int = 32):
        ex = [e for e in examples if e is not None]
        if not ex:
            return None
        lt = _round_up(max(len(e["text"]) for e in ex), pad_to)
        lm = _round_up(max(e["mel"].shape[0] for e in ex), pad_to)
        lr = _round_up(max(e["refer"].shape[0] for e in ex), pad_to)
        lc = _round_up(max(len(e["codes"]) for e in ex), pad_to)
        return {
            "text": np.stack([_pad_to(e["text"], lt) for e in ex]),
            "text_lengths": np.asarray([len(e["text"]) for e in ex], np.int32),
            "mel": np.stack([_pad_to(e["mel"], lm) for e in ex]),
            "mel_lengths": np.asarray([e["mel"].shape[0] for e in ex], np.int32),
            "mel_refer": np.stack([_pad_to(e["refer"], lr) for e in ex]),
            "refer_lengths": np.asarray([e["refer"].shape[0] for e in ex], np.int32),
            "mel_codes": np.stack([_pad_to(e["codes"], lc) for e in ex]),
            "wav_lengths": np.asarray([e["wav_length"] for e in ex], np.int32),
        }


class VQGANDataset:
    """wav (+ text) for codec GAN training."""

    def __init__(self, manifest_path: str, sample_rate: int = 32000, hop_length: int = 640,
                 min_seconds: float = 0.65, max_seconds: float = 54.0,
                 tokenizer: Optional[VoiceBpeTokenizer] = None):
        self.rows = read_manifest(manifest_path)
        self.sample_rate = sample_rate
        self.hop = hop_length
        self.min_samples = int(min_seconds * sample_rate)
        self.max_samples = int(max_seconds * sample_rate)
        self.tok = tokenizer or default_tokenizer()

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, idx: int) -> Optional[dict]:
        row = self.rows[idx]
        try:
            wav, _ = load_wav(row["path"], target_sr=self.sample_rate)
            if not (self.min_samples <= len(wav) <= self.max_samples):
                return None  # vqvae/dataset.py:43-49
            wav = np.clip(wav[: (len(wav) // self.hop) * self.hop], -1.0, 1.0)
            ids = np.asarray(self.tok.encode(text_to_pinyin(row["text"])), np.int32)
            return {"wav": wav.astype(np.float32), "text": ids}
        except Exception:
            return None

    def collate(self, examples, pad_to_frames: int = 8):
        ex = [e for e in examples if e is not None]
        if not ex:
            return None
        frames = [len(e["wav"]) // self.hop for e in ex]
        lf = _round_up(max(frames), pad_to_frames)
        lt = _round_up(max(len(e["text"]) for e in ex), 16)
        wav = np.stack([_pad_to(e["wav"], lf * self.hop) for e in ex])[..., None]
        return {
            "wav": wav,
            "wav_lengths": np.asarray([len(e["wav"]) for e in ex], np.int32),
            "spec_lengths": np.asarray(frames, np.int32),
            "text": np.stack([_pad_to(e["text"], lt) for e in ex]),
            "text_lengths": np.asarray([len(e["text"]) for e in ex], np.int32),
        }


class CLVPDataset:
    """text ids + speech VQ codes (the `.vq` sidecars)."""

    def __init__(self, manifest_path: str, tokenizer: Optional[VoiceBpeTokenizer] = None):
        self.rows = read_manifest(manifest_path)
        self.tok = tokenizer or default_tokenizer()

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, idx: int) -> Optional[dict]:
        row = self.rows[idx]
        try:
            ids = np.asarray(self.tok.encode(text_to_pinyin(row["text"])), np.int32)
            codes = load_sidecar(row["path"], "vq")
            if codes is None:
                return None
            return {"text": ids, "speech_tokens": np.asarray(codes, np.int32).reshape(-1)}
        except Exception:
            return None

    def lengths(self) -> List[int]:
        """Per-row VQ-code count from the sidecar header (-1 = missing)."""
        out = []
        for r in self.rows:
            shp = sidecar_shape(r["path"], "vq")
            out.append(int(np.prod(shp)) if shp else -1)
        return out

    def collate(self, examples, pad_to: int = 32):
        ex = [e for e in examples if e is not None]
        if not ex:
            return None
        lt = _round_up(max(len(e["text"]) for e in ex), pad_to)
        ls = _round_up(max(len(e["speech_tokens"]) for e in ex), pad_to)
        return {
            "text": np.stack([_pad_to(e["text"], lt) for e in ex]),
            "speech_tokens": np.stack([_pad_to(e["speech_tokens"], ls) for e in ex]),
        }


class PreprocessedMelDataset:
    """Clean / noise `.mel` sidecars for the audio-quality classifier. Each
    line of `clean_list` / `noise_list` is a wav path (its `<wav>.mel.npy`
    sidecar) or a directory (its `*.mel.npy` files, recursively, sorted);
    clean lines label 0, noise lines 1. Mels are channels-last (T, spec_dim),
    random-cropped to `pad_to` frames or zero-padded up to it."""

    def __init__(self, clean_list: str, noise_list: str, pad_to: int = 700,
                 spec_dim: int = 100, rng: Optional[np.random.Generator] = None):
        self.items: List[tuple] = []
        for list_path, label in ((clean_list, 0), (noise_list, 1)):
            for line in pathlib.Path(list_path).read_text().splitlines():
                line = line.strip()
                if not line:
                    continue
                if line.endswith(".wav"):
                    self.items.append((line + ".mel.npy", label))
                else:
                    self.items.extend((str(p), label)
                                      for p in sorted(pathlib.Path(line).rglob("*.mel.npy")))
        self.pad_to = pad_to
        self.spec_dim = spec_dim
        self.rng = rng or np.random.default_rng(0)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx: int) -> Optional[dict]:
        path, label = self.items[idx]
        try:
            mel = np.asarray(np.load(path), np.float32)
            if mel.ndim == 3:
                mel = mel[0]
            # sidecars are channels-first (spec_dim, T); spec_dim decides the
            # orientation of a short clip
            if mel.shape[-1] != self.spec_dim:
                mel = mel.T
            t = mel.shape[0]
            if t >= self.pad_to:
                start = int(self.rng.integers(0, t - self.pad_to + 1))
                mel = mel[start:start + self.pad_to]
            else:
                mel = np.pad(mel, ((0, self.pad_to - t), (0, 0)))
            return {"mel": mel, "label": int(label)}
        except Exception:
            return None

    def collate(self, examples, pad_to: int = 0):
        ex = [e for e in examples if e is not None]
        if not ex:
            return None
        return {"mel": np.stack([e["mel"] for e in ex]),
                "labels": np.asarray([e["label"] for e in ex], np.int32)}
