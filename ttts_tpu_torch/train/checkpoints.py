"""Checkpoints, port of ttts_tpu/train/checkpoints.py: keep-N rotating
training checkpoints, and the half-precision weights-only release export.

`CheckpointManager` writes one `torch.save` file per step (`step_<n>.pt`,
written to a temporary name and renamed into place): whatever tree the
trainer hands it (the model, optimizer, EMA, step and generator states).
The JAX package's Orbax directories stay on its side (Orbax imports JAX).

`export_release` writes the JAX package's release `.npz`: the flattened
variable paths joined by 0x1f, float32 stored as float16, training-only
submodules dropped, and a `__config__` JSON blob. `export_model` takes one
of this package's state dicts there through porting.VARIABLES_FNS, so the
file loads in ttts_tpu.train.checkpoints.load_release and in this
package's infer_utils.load_model / TextToSpeech.from_checkpoints alike.
"""

from __future__ import annotations

import json
import os
import pathlib
import re
from typing import Any, List, Optional

import numpy as np
import torch

from ttts_tpu_torch import porting
from ttts_tpu_torch.infer_utils import SEP

_NAME = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    """Keep-N rotating checkpoints of arbitrary picklable trees."""

    def __init__(self, directory: str | pathlib.Path, keep: int = 3):
        self.directory = pathlib.Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def path(self, step: int) -> pathlib.Path:
        return self.directory / f"step_{step:08d}.pt"

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for f in self.directory.iterdir()
                      if (m := _NAME.match(f.name)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any):
        """Write `tree` for `step` and drop all but the newest `keep`
        checkpoints."""
        tmp = self.directory / f".step_{step:08d}.pt.tmp"
        torch.save(tree, tmp)
        os.replace(tmp, self.path(step))
        for old in self.all_steps()[:-self.keep] if self.keep > 0 else []:
            self.path(old).unlink(missing_ok=True)

    def restore(self, step: Optional[int] = None):
        """(step, tree) of `step` (the latest when None) on the CPU, or
        (None, None) when there is none."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        return step, torch.load(self.path(step), map_location="cpu", weights_only=False)


def export_release(params: Any, path: str | pathlib.Path, drop_prefixes=("enc_q",),
                   config: Optional[dict] = None):
    """JAX variables (nested dicts of arrays) → a release `.npz` as the JAX
    package's export_release writes it: keys whose first or second path
    segment is a dropped prefix are left out, float32 is stored as
    float16."""
    flat = {}

    def visit(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                visit(v, f"{prefix}{k}{SEP}")
            return
        key = prefix[:-1]
        if any(s == p for s in key.split(SEP)[:2] for p in drop_prefixes):
            return
        arr = np.asarray(tree)
        flat[key] = arr.astype(np.float16) if arr.dtype == np.float32 else arr

    visit(params)
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    meta = json.dumps(config or {})
    np.savez_compressed(path, __config__=np.frombuffer(meta.encode(), np.uint8), **flat)


def export_model(name: str, state_dict, path: str | pathlib.Path,
                 config: Optional[dict] = None):
    """One of this package's state dicts ("gpt" or "diffusion") → a release
    `.npz` of the JAX variables (porting.VARIABLES_FNS)."""
    export_release(porting.VARIABLES_FNS[name](state_dict), path, config=config)
