"""jsonl manifests and per-wav sidecar tensors, port of ttts_tpu/data/
manifest.py: rows {'text': str, 'path': str} (ttts/prepare/asr_process.py),
sidecars `<wav>.mel.npy` / `<wav>.vq.npy`, and the reference's legacy
`.pth` pickles read with torch.load."""

from __future__ import annotations

import json
import pathlib
from typing import Iterable, List, Optional

import numpy as np


def read_manifest(path: str | pathlib.Path) -> List[dict]:
    rows = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def write_manifest(path: str | pathlib.Path, rows: Iterable[dict]):
    with open(path, "w", encoding="utf-8") as f:
        for r in rows:
            f.write(json.dumps(r, ensure_ascii=False) + "\n")


def sidecar_path(audio_path: str, kind: str) -> pathlib.Path:
    """`<wav>.mel.npy` / `<wav>.vq.npy` next to the audio file."""
    return pathlib.Path(audio_path + f".{kind}.npy")


def load_sidecar(audio_path: str, kind: str) -> Optional[np.ndarray]:
    npy = sidecar_path(audio_path, kind)
    if npy.exists():
        return np.load(npy)
    pth = pathlib.Path(audio_path + f".{kind}.pth")
    if pth.exists():
        import torch  # legacy reference artifacts

        t = torch.load(pth, map_location="cpu", weights_only=False)
        if isinstance(t, list):
            return np.asarray(t)
        return t.numpy() if hasattr(t, "numpy") else np.asarray(t)
    return None


def save_sidecar(audio_path: str, kind: str, array: np.ndarray):
    np.save(sidecar_path(audio_path, kind), array)


def sidecar_shape(audio_path: str, kind: str) -> Optional[tuple]:
    """A sidecar's shape without loading its data (the .npy header through
    mmap; a legacy .pth is loaded whole)."""
    npy = sidecar_path(audio_path, kind)
    if npy.exists():
        try:
            return tuple(np.load(npy, mmap_mode="r").shape)
        except Exception:
            return None
    arr = load_sidecar(audio_path, kind)
    return None if arr is None else tuple(arr.shape)
