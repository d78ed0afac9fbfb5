"""Model registry and release-checkpoint loader, port of ttts_tpu/
infer_utils.py.

`load_model(name, path, cfg)` builds one of this package's models and loads
a release `.npz`, the format of ttts_tpu.train.checkpoints.export_release
(read here with numpy alone): flattened flax variable paths joined by 0x1f,
float32 weights stored as float16 and read back as float32, and a
`__config__` JSON blob. The variables map onto the model's state dict
through porting.STATE_DICT_FNS, whose codec function reads the codebook
state in the dict form the file holds (the JAX package rebuilds RVQState
structs from it, quantize.rvq_state_from_dict). Orbax checkpoint
directories stay with the JAX package: Orbax imports JAX.
"""

from __future__ import annotations

import json
import pathlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ttts_tpu_torch import porting
from ttts_tpu_torch.config import TTTSConfig, default_config

SEP = "\x1f"  # export_release's key separator

# the JAX registry's model names → the porting.STATE_DICT_FNS key (the
# serving stage, or "classifier", which serving does not hold)
STAGES = {"vqvae": "codec", "gpt": "gpt", "diffusion": "diffusion", "vocos": "vocos",
          "clvp": "clvp", "classifier": "classifier"}


def build_model(name: str, cfg: Optional[TTTSConfig] = None) -> nn.Module:
    """The named model of `cfg` (default_config()) with random weights, in
    eval mode, on the CPU."""
    cfg = cfg or default_config()
    if name == "vqvae":
        from ttts_tpu_torch.models.vqvae import SynthesizerTrn

        model = SynthesizerTrn(cfg.vqvae, spec_channels=cfg.audio.filter_length // 2 + 1)
    elif name == "gpt":
        from ttts_tpu_torch.models.gpt import UnifiedVoice

        model = UnifiedVoice(cfg.gpt)
    elif name == "diffusion":
        from ttts_tpu_torch.models.diffusion_net import AA_diffusion

        model = AA_diffusion(cfg.diffusion_net)
    elif name == "vocos":
        from ttts_tpu_torch.models.vocos import Vocos

        model = Vocos(cfg.vocos)
    elif name == "clvp":
        from ttts_tpu_torch.models.clvp import CLVP

        model = CLVP(cfg.clvp)
    elif name == "classifier":
        from ttts_tpu_torch.models.classifier import AudioMiniEncoderWithClassifierHead

        model = AudioMiniEncoderWithClassifierHead(cfg.classifier)
    else:
        raise KeyError(f"unknown model {name!r} (models: {sorted(STAGES)})")
    return model.eval()


def load_release(path: str | pathlib.Path) -> Tuple[dict, dict]:
    """An export_release `.npz` → (nested dict of numpy arrays, float16
    read back as float32; the embedded config dict)."""
    with np.load(path) as data:
        cfg = json.loads(bytes(data["__config__"]).decode()) if "__config__" in data else {}
        tree: dict = {}
        for k in data.files:
            if k == "__config__":
                continue
            parts = k.split(SEP)
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            arr = data[k]
            node[parts[-1]] = arr.astype(np.float32) if arr.dtype == np.float16 else arr
    return tree, cfg


def load_state_dict(name: str, path: str | pathlib.Path) -> Dict[str, np.ndarray]:
    """A release `.npz` of the named model → its state dict in this package."""
    p = pathlib.Path(path)
    if p.is_dir() or p.suffix != ".npz":
        raise ValueError(f"{p}: this package reads release .npz files (export_release); "
                         "Orbax checkpoint directories are read by the JAX package, "
                         "ttts_tpu.infer_utils.load_model")
    if name not in STAGES:
        raise KeyError(f"unknown model {name!r} (models: {sorted(STAGES)})")
    tree, _ = load_release(p)
    return porting.STATE_DICT_FNS[STAGES[name]](tree)


def load_model(name: str, ckpt_path: Optional[str | pathlib.Path] = None,
               cfg: Optional[TTTSConfig] = None):
    """(model, state dict): the named model of `cfg` on the CPU, with the
    release `.npz` at `ckpt_path` loaded (strict keys); the state dict is
    None, and the weights random, without a path."""
    model = build_model(name, cfg)
    if ckpt_path is None:
        return model, None
    sd = load_state_dict(name, ckpt_path)
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    return model, sd


def prepare_device(device) -> torch.device:
    """`device` as a torch.device. A CUDA device must exist, and on it
    matmuls and cuDNN convolutions stay out of TF32, so that the codec's
    f32 convolutions and the VQ search stay IEEE f32."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device
