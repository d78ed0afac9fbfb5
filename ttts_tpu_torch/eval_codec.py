"""Codec reconstruction check, port of ttts_tpu/eval_codec.py (reference
ttts/vqvae/eval.py): load a release codec checkpoint, reconstruct one wav
through SynthesizerTrn.infer (the VQ kernel on the card), write it.

usage: python -m ttts_tpu_torch.eval_codec --ckpt codec.npz --wav in.wav
           [--out gen.wav] [--config cfg.json] [--noise-scale 0.5] [--device cuda]

The checkpoint is a release `.npz` of export_release; the device is the card
unless --device cpu is given. The wav is cut to whole hops; infer needs an
even number of spectrogram frames, as the JAX package does.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ttts_tpu_torch.config import default_config, load_config
from ttts_tpu_torch.data.audio import load_wav, save_wav
from ttts_tpu_torch.infer_utils import load_model, prepare_device
from ttts_tpu_torch.ops.mel import vits_spectrogram


@torch.no_grad()
def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--wav", required=True)
    p.add_argument("--out", default="gen.wav")
    p.add_argument("--config", default=None)
    p.add_argument("--noise-scale", type=float, default=0.5)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = load_config(args.config) if args.config else default_config()
    a = cfg.audio
    device = prepare_device(args.device)
    model, _ = load_model("vqvae", args.ckpt, cfg)
    model.to(device)

    wav, _ = load_wav(args.wav, target_sr=a.sampling_rate)
    t = (len(wav) // a.hop_length) * a.hop_length
    wav = torch.as_tensor(wav[:t], device=device)[None]
    spec = vits_spectrogram(wav, a.filter_length, a.hop_length, a.win_length).transpose(1, 2)
    text = torch.zeros((1, 1), dtype=torch.long, device=device)  # unconditioned text
    out = model.infer(wav[..., None], spec, torch.tensor([spec.shape[1]], device=device),
                      text, torch.tensor([1], device=device), args.noise_scale,
                      generator=torch.Generator(device).manual_seed(0))
    save_wav(args.out, out[0, :, 0].cpu().numpy(), a.sampling_rate)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
