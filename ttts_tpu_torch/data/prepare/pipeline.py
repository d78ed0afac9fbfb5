"""Offline preprocessing pipeline, port of ttts_tpu/data/prepare/pipeline.py
(the reference's prepare stages, SURVEY §2.8 / §3.5), one subcommand each:

  vad        silence-split raw audio into 0.7-30 s clips at 32 kHz
             (1_vad_asr_save_to_jsonl.py phase 1 + vad_process.py:6-31;
             the energy VAD of data/audio.py)
  asr        transcribe clips to a jsonl manifest through a --hook module's
             transcribe(path) -> str (the reference's ModelScope Paraformer
             is not in this repository), keeping texts of >= 5 characters
             without Latin letters (asr_process.py:36-43)
  mel        write <wav>.mel.npy sidecars: the 24 kHz 100-bin log mel
             (100, T) of acoustic_mel_spectrogram (save_mel_to_disk.py)
  vq         write <wav>.vq.npy sidecars: the codec's extract_code codes
             (2_save_vq_to_disk.py + extract_vq.py:13-23; the GPT's
             training vocabulary), the wav cut to whole hops; on the card
             each clip is one launch of the VQ kernel
  bpe-corpus merge transcripts into a pinyin corpus for BPE training
             (prepare/bpe_all_text_to_one_file.py)
  filter-noise     drop the rows listed in a noise file (the classifier's
             output; filter_noise_and_other_spk.py:23)
  filter-nohifreq  flag audio whose top ~2 kHz band of a 22 kHz-wide STFT
             has a mean magnitude below 0.08 (script/filter_nohifreq_data.py
             :8-21)

mel and vq run on the card unless --device cpu is given, in f32 with TF32
off; vq reads the codec from this package's `train.mains vqvae`
checkpoints (the generator of the GAN state: the `ckpt` directory or the
logs folder holding it) or from a release `.npz`.
"""

from __future__ import annotations

import argparse
import importlib
import pathlib
from typing import List, Optional

import numpy as np
import torch

from ttts_tpu_torch.data.audio import load_wav, save_wav, vad_split
from ttts_tpu_torch.data.manifest import read_manifest, save_sidecar, write_manifest
from ttts_tpu_torch.text import text_to_pinyin
from ttts_tpu_torch.utils.logging import get_logger

log = get_logger("prepare")


def cmd_vad(args):
    out_dir = pathlib.Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    sr = 32000
    min_len, max_len = int(0.7 * sr), int(30 * sr)
    count = 0
    for path in sorted(pathlib.Path(args.in_dir).rglob("*.wav")):
        wav, _ = load_wav(path, target_sr=sr)
        for i, (s, e) in enumerate(vad_split(wav, sr, min_silence_ms=500,
                                             silence_thresh_db=-40)):
            clip = wav[s:e]
            if min_len <= len(clip) <= max_len:
                save_wav(out_dir / f"{path.stem}_{i:04d}.wav", clip, sr)
                count += 1
    log.info("vad: wrote %d clips to %s", count, out_dir)


def cmd_asr(args):
    if not args.hook:
        raise SystemExit("no ASR backend in this environment; pass --hook my_module "
                         "exposing transcribe(path)->str (the reference used ModelScope "
                         "Paraformer, asr_process.py:15-19)")
    transcribe = importlib.import_module(args.hook).transcribe
    rows = []
    for path in sorted(pathlib.Path(args.in_dir).rglob("*.wav")):
        text = transcribe(str(path))
        if text and len(text) >= 5 and not any("a" <= ch.lower() <= "z" for ch in text):
            rows.append({"text": text, "path": str(path)})
    write_manifest(args.out, rows)
    log.info("asr: %d rows → %s", len(rows), args.out)


@torch.no_grad()
def cmd_mel(args):
    from ttts_tpu_torch.infer_utils import prepare_device
    from ttts_tpu_torch.ops.mel import acoustic_mel_spectrogram

    device = prepare_device(args.device)
    rows = read_manifest(args.manifest)
    for row in rows:
        wav, _ = load_wav(row["path"], target_sr=24000)
        mel = acoustic_mel_spectrogram(torch.as_tensor(wav, device=device)[None])
        save_sidecar(row["path"], "mel", mel[0].cpu().numpy())
    log.info("mel: wrote %d sidecars", len(rows))


def load_codec(ckpt: str, cfg, device) -> torch.nn.Module:
    """The codec of a `train.mains vqvae` checkpoint (the GAN state's
    generator, built for training) or of a release `.npz`, in eval mode
    on `device`."""
    from ttts_tpu_torch.models.vqvae import SynthesizerTrn
    from ttts_tpu_torch.train.checkpoints import trained_state_dict

    a = cfg.audio
    sd, training = trained_state_dict("vqvae", ckpt)
    codec = SynthesizerTrn(cfg.vqvae, spec_channels=a.filter_length // 2 + 1,
                           segment_frames=cfg.train.segment_size // a.hop_length,
                           for_training=training)
    codec.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()})
    return codec.to(device).eval().requires_grad_(False)


@torch.no_grad()
def extract_codes(codec, wav: np.ndarray, audio_cfg, device) -> np.ndarray:
    """A mono wav at the codec's rate → its semantic codes (T/2,) int32: the
    wav cut to whole hops, its linear spectrogram, extract_code's first
    quantizer."""
    from ttts_tpu_torch.ops.mel import vits_spectrogram

    a = audio_cfg
    t = (len(wav) // a.hop_length) * a.hop_length
    w = torch.as_tensor(wav[:t], device=device)[None]
    spec = vits_spectrogram(w, a.filter_length, a.hop_length, a.win_length).transpose(1, 2)
    codes = codec.extract_code(w[..., None], spec, torch.tensor([spec.shape[1]], device=device))
    return codes[0, 0].cpu().numpy().astype(np.int32)


def cmd_vq(args):
    from ttts_tpu_torch.config import default_config, load_config
    from ttts_tpu_torch.infer_utils import prepare_device

    cfg = load_config(args.config) if args.config else default_config()
    device = prepare_device(args.device)
    codec = load_codec(args.ckpt, cfg, device)
    rows = read_manifest(args.manifest)
    for row in rows:
        wav, _ = load_wav(row["path"], target_sr=cfg.audio.sampling_rate)
        save_sidecar(row["path"], "vq", extract_codes(codec, wav, cfg.audio, device))
    log.info("vq: wrote %d sidecars", len(rows))


def cmd_bpe_corpus(args):
    lines = [text_to_pinyin(row["text"]) for manifest in args.manifests
             for row in read_manifest(manifest)]
    with open(args.out, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    log.info("bpe-corpus: %d lines → %s", len(lines), args.out)


def cmd_filter_noise(args):
    with open(args.noise_files) as f:
        noise = {line.strip() for line in f if line.strip()}
    rows = [r for r in read_manifest(args.manifest) if r["path"] not in noise]
    write_manifest(args.out, rows)
    log.info("filter-noise: kept %d rows → %s", len(rows), args.out)


@torch.no_grad()
def cmd_filter_nohifreq(args):
    """Flags (on the host) audio whose top-2000-bin mean STFT magnitude,
    with n_fft = min(22000, the largest power of two below the length) and
    hop 1024, is below 0.08; clips under 22050 samples are skipped."""
    from ttts_tpu_torch.ops.stft import stft

    flagged = []
    for row in read_manifest(args.manifest):
        wav, _ = load_wav(row["path"])
        if len(wav) < 22050:
            continue
        n_fft = min(22000, 2 ** int(np.log2(max(len(wav) - 1, 2))))
        spec = stft(torch.as_tensor(wav)[None], n_fft, 1024, n_fft, center=True)
        if float(spec.abs()[0, -2000:, :].mean()) < 0.08:
            flagged.append(row["path"])
    with open(args.out, "w") as f:
        f.write("\n".join(flagged) + "\n")
    log.info("filter-nohifreq: flagged %d files", len(flagged))


def main(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("vad")
    s.add_argument("--in-dir", required=True)
    s.add_argument("--out-dir", required=True)
    s.set_defaults(run=cmd_vad)

    s = sub.add_parser("asr")
    s.add_argument("--in-dir", required=True)
    s.add_argument("--out", required=True)
    s.add_argument("--hook", default=None)
    s.set_defaults(run=cmd_asr)

    s = sub.add_parser("mel")
    s.add_argument("--manifest", required=True)
    s.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    s.set_defaults(run=cmd_mel)

    s = sub.add_parser("vq")
    s.add_argument("--manifest", required=True)
    s.add_argument("--ckpt", required=True,
                   help="a train.mains vqvae checkpoint directory or a release .npz")
    s.add_argument("--config", default=None)
    s.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    s.set_defaults(run=cmd_vq)

    s = sub.add_parser("bpe-corpus")
    s.add_argument("manifests", nargs="+")
    s.add_argument("--out", required=True)
    s.set_defaults(run=cmd_bpe_corpus)

    s = sub.add_parser("filter-noise")
    s.add_argument("--manifest", required=True)
    s.add_argument("--noise-files", required=True)
    s.add_argument("--out", required=True)
    s.set_defaults(run=cmd_filter_noise)

    s = sub.add_parser("filter-nohifreq")
    s.add_argument("--manifest", required=True)
    s.add_argument("--out", required=True)
    s.set_defaults(run=cmd_filter_nohifreq)

    args = p.parse_args(argv)
    args.run(args)


if __name__ == "__main__":
    main()
