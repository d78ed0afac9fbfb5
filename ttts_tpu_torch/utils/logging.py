"""Metrics and logging, port of ttts_tpu/utils/logging.py.

`SummaryWriter.summarize` has the JAX writer's signature (scalars,
histograms, images, audios, audio_sampling_rate) but writes plain files, as
the card's machine has no tensorboard(X) or matplotlib:
  - scalars as JSON lines in `logdir/scalars.jsonl` ({"step", "wall",
    name: value});
  - each histogram and image as `logdir/<tag>/<step>.npy` (the array the
    JAX writer hands tensorboardX);
  - each audio as a 16-bit `logdir/<tag>/<step>.wav` written by save_wav.
`plot_spectrogram_to_numpy` renders a spectrogram as an image with
matplotlib, imported on first use (the eval hooks hand the writer the mel
arrays themselves, so training needs no matplotlib). `get_logger` is the
JAX package's file + console logger. `profile_trace(logdir)` traces the
block with torch.profiler (the host and, where there is one, the card) and
writes a Chrome trace under logdir, as the JAX package's jax.profiler
trace; a None logdir traces nothing. `span(name)` names a stretch of the
program in such a trace (a torch.profiler host range, on the clock the
device events share) and costs a flag test when no profiler records.
"""

from __future__ import annotations

import contextlib
import json
import logging
import pathlib
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch


class SummaryWriter:
    """Scalars as JSON lines in `logdir/scalars.jsonl`; arrays and audio as
    files under `logdir/<tag>/<step>`."""

    def __init__(self, logdir: str | pathlib.Path):
        self.logdir = pathlib.Path(logdir)
        self.path = self.logdir / "scalars.jsonl"
        self.logdir.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a", encoding="utf-8")

    def _file(self, tag: str, step: int, suffix: str) -> pathlib.Path:
        d = self.logdir / tag
        d.mkdir(parents=True, exist_ok=True)
        return d / f"{int(step)}{suffix}"

    def summarize(self, global_step: int, scalars: Optional[Dict[str, float]] = None,
                  histograms: Optional[Dict] = None, images: Optional[Dict] = None,
                  audios: Optional[Dict] = None, audio_sampling_rate: int = 24000):
        if scalars:
            row = {"step": int(global_step), "wall": time.time()}
            row.update({k: float(v) for k, v in scalars.items()})
            self._f.write(json.dumps(row) + "\n")
            self._f.flush()
        for tag, v in {**(histograms or {}), **(images or {})}.items():
            np.save(self._file(tag, global_step, ".npy"), np.asarray(v))
        if audios:
            from ttts_tpu_torch.data.audio import save_wav

            for tag, v in audios.items():
                save_wav(self._file(tag, global_step, ".wav"),
                         np.asarray(v, np.float32).reshape(-1), audio_sampling_rate)

    def close(self):
        self._f.close()


def get_logger(name: str = "ttts_tpu_torch", log_file: Optional[str] = None) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        logger.setLevel(logging.INFO)
        fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
        sh = logging.StreamHandler(sys.stderr)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        if log_file:
            fh = logging.FileHandler(log_file)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger


def plot_spectrogram_to_numpy(spectrogram: np.ndarray) -> np.ndarray:
    """A (C, T) or (T, C) spectrogram → an HWC uint8 image (the longer axis
    is time)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    spec = np.asarray(spectrogram)
    if spec.shape[0] > spec.shape[1]:
        spec = spec.T
    fig, ax = plt.subplots(figsize=(10, 2))
    im = ax.imshow(spec, aspect="auto", origin="lower", interpolation="none")
    plt.colorbar(im, ax=ax)
    fig.canvas.draw()
    data = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return data


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]):
    """torch.profiler over the block (the CPU, and CUDA where a card is
    present), its Chrome trace written to `logdir/trace_<pid>_<n>.json`;
    nothing for None. Yields the profiler (None for None)."""
    if logdir is None:
        yield None
        return
    import os

    from torch.profiler import ProfilerActivity, profile

    out = pathlib.Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        yield prof
    n = len(list(out.glob(f"trace_{os.getpid()}_*.json")))
    prof.export_chrome_trace(str(out / f"trace_{os.getpid()}_{n}.json"))


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A host range `name` (every span of the program is named `ttts.*`)
    while a torch.profiler session records on this thread, else one
    shared no-op context: no record_function, no allocation."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN
