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
Batches pad to multiples of `pad_to`, as the JAX package's do. The VQ-GAN,
CLVP and mel-classifier datasets are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

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
