"""Metrics and logging, port of ttts_tpu/utils/logging.py.

`SummaryWriter` keeps the reference's `summarize` API but writes scalars
only, as JSON lines (`scalars.jsonl`: {"step", "wall", name: value}) in its
directory: the card's machine has no tensorboard(X) or matplotlib, so there
are no event files, histograms, images or audio. `get_logger` is the JAX
package's file + console logger.
"""

from __future__ import annotations

import json
import logging
import pathlib
import sys
import time
from typing import Dict, Optional


class SummaryWriter:
    """Scalars as JSON lines in `logdir/scalars.jsonl`."""

    def __init__(self, logdir: str | pathlib.Path):
        self.path = pathlib.Path(logdir) / "scalars.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a", encoding="utf-8")

    def summarize(self, global_step: int, scalars: Optional[Dict[str, float]] = None, **_):
        """Writes `scalars`; the JAX writer's histograms, images and audios
        are accepted and dropped (no renderer here)."""
        row = {"step": int(global_step), "wall": time.time()}
        row.update({k: float(v) for k, v in (scalars or {}).items()})
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()

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
