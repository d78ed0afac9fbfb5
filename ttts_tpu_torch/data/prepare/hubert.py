"""HuBERT feature sidecars, port of ttts_tpu/data/prepare/hubert.py
(reference ttts/prepare/hubert_to_disk.py + ttts/utils/cnhubert.py): writes
`<wav>.hubert.npy`, the 16 kHz content features that RVQ1's training
forward distils (models/rvq1.py).

HuBERT is a third-party model: a local checkpoint directory (such as
chinese-hubert-base) loaded through HuggingFace `transformers`, which is
imported on first use; without it the loader raises an ImportError that
names it. The model runs on the card unless --device cpu is given.

usage: python -m ttts_tpu_torch.data.prepare.hubert --manifest m.jsonl \
    --model-dir hubert/ [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ttts_tpu_torch.data.audio import load_wav
from ttts_tpu_torch.data.manifest import read_manifest, save_sidecar
from ttts_tpu_torch.utils.logging import get_logger

log = get_logger("prepare.hubert")


def transformers_module():
    """`transformers`, or an ImportError that says what needs it."""
    try:
        import transformers
    except ImportError as e:
        raise ImportError("the HuBERT and wav2vec2 tools need the `transformers` package, "
                          "which is not installed") from e
    return transformers


def get_hubert_model(model_dir: str, device="cuda"):
    """A local HuBERT checkpoint (vc_utils.get_hubert_model:210 /
    cnhubert.py:20) on `device`, in eval mode → (model, feature extractor)."""
    from ttts_tpu_torch.infer_utils import prepare_device

    tf = transformers_module()
    extractor = tf.Wav2Vec2FeatureExtractor.from_pretrained(model_dir)
    model = tf.HubertModel.from_pretrained(model_dir).to(prepare_device(device)).eval()
    return model, extractor


def extract_hubert(model, extractor, wav16k: np.ndarray) -> np.ndarray:
    """A 16 kHz waveform → its last hidden states (frames, hidden) f32."""
    inputs = extractor(wav16k, sampling_rate=16000, return_tensors="pt")
    device = next(model.parameters()).device
    with torch.no_grad():
        out = model(inputs.input_values.to(device)).last_hidden_state
    return out[0].float().cpu().numpy()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--manifest", required=True)
    p.add_argument("--model-dir", required=True, help="local chinese-hubert-base directory")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    model, extractor = get_hubert_model(args.model_dir, args.device)
    rows = read_manifest(args.manifest)
    for row in rows:
        wav, _ = load_wav(row["path"], target_sr=16000)
        save_sidecar(row["path"], "hubert", extract_hubert(model, extractor, wav))
    log.info("hubert: wrote %d sidecars", len(rows))


if __name__ == "__main__":
    main()
