"""Dataset hygiene tools, port of ttts_tpu/data/prepare/misc.py (the
reference's ttts/prepare/ leftovers and ttts/script/):

  classify     run the audio-quality classifier over a manifest and write
               noise_files.txt, the clips not of class 0 (ttts/classifier/
               infer.py classify_audio_clip; the input of `pipeline
               filter-noise`); on the card unless --device cpu is given
  unique-spk   per speaker folder, flag the clips that a speaker-
               verification hook says mismatch a random reference clip
               (prepare/unique_spk.py + unique_spk_process.py; the SV model,
               ModelScope CAM++ in the reference, is injected)
  prune-single-wav  list (or delete) folders holding exactly one wav
               (prepare/delete_one_file_dir.py)
  remove-empty drop manifest rows whose audio is missing or empty
               (prepare/remove_empty_paths.py)
  do-to-files  apply `module:function` to every file of a list in a
               process pool (script/do_to_files.py)

The subcommand's function is kept under `run`: JAX's parser keeps it under
`fn`, which do-to-files' own --fn overwrites, so that its CLI calls a
string (ROADMAP.md queue 3).
"""

from __future__ import annotations

import argparse
import importlib
import json
import pathlib
import random
import shutil
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

from ttts_tpu_torch.data.manifest import read_manifest, write_manifest
from ttts_tpu_torch.utils.logging import get_logger

log = get_logger("prepare.misc")


@torch.no_grad()
def classify_audio_clip(model, mel: torch.Tensor) -> int:
    """The argmax class of one (T, spec_dim) mel (classifier/infer.py:16)."""
    return int(model(mel[None]).argmax(dim=-1)[0])


def load_classifier(ckpt: str, cfg, device) -> torch.nn.Module:
    """The classifier of a release `.npz` (export_model("classifier")) or of
    a `train.mains classifier` checkpoint, in eval mode on `device`."""
    from ttts_tpu_torch.infer_utils import build_model
    from ttts_tpu_torch.train.checkpoints import trained_state_dict

    model = build_model("classifier", cfg)
    sd, _ = trained_state_dict("classifier", ckpt)
    model.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()})
    return model.to(device).eval().requires_grad_(False)


def cmd_classify(args):
    from ttts_tpu_torch.config import default_config, load_config
    from ttts_tpu_torch.data.audio import load_wav
    from ttts_tpu_torch.infer_utils import prepare_device
    from ttts_tpu_torch.ops.mel import acoustic_mel_spectrogram

    cfg = load_config(args.config) if args.config else default_config()
    device = prepare_device(args.device)
    model = load_classifier(args.ckpt, cfg, device)
    rows = read_manifest(args.manifest)
    flagged = []
    for row in rows:
        wav, _ = load_wav(row["path"], target_sr=24000)
        with torch.no_grad():
            mel = acoustic_mel_spectrogram(torch.as_tensor(wav, device=device)[None])
        if classify_audio_clip(model, mel[0].T) != 0:
            flagged.append(row["path"])
    pathlib.Path(args.out).write_text("\n".join(flagged) + "\n")
    log.info("classify: flagged %d/%d", len(flagged), len(rows))


def cmd_remove_empty(args):
    rows = [r for r in read_manifest(args.manifest)
            if (p := pathlib.Path(r["path"])).exists() and p.stat().st_size > 44]
    write_manifest(args.out, rows)
    log.info("remove-empty: kept %d rows", len(rows))


def unique_spk_scan(root: str, same_speaker, rng=None) -> list:
    """Per speaker folder: a reference clip drawn from its wavs after the
    first (unique_spk_process.py:14-41), and every clip that
    `same_speaker(ref_path, path) -> bool` rejects flagged; a folder of one
    clip is flagged whole. → [{"path", "reason"}]."""
    rng = rng or random.Random(0)
    flagged = []
    for folder in sorted(p for p in pathlib.Path(root).iterdir() if p.is_dir()):
        wavs = sorted(str(x) for x in folder.glob("*.wav"))
        if not wavs:
            continue
        if len(wavs) == 1:
            flagged.append({"path": wavs[0], "reason": "single-clip-folder"})
            continue
        ref = rng.choice(wavs[1:])
        flagged.extend({"path": w, "reason": "speaker-mismatch"}
                       for w in wavs if not same_speaker(ref, w))
    return flagged


def cmd_unique_spk(args):
    if not args.sv_hook:
        raise SystemExit("no speaker-verification backend in this environment; pass "
                         "--sv-hook my_module exposing same_speaker(ref_path, path)->bool "
                         "(the reference used ModelScope CAM++, unique_spk_process.py:8-12)")
    flagged = unique_spk_scan(args.root, importlib.import_module(args.sv_hook).same_speaker)
    with open(args.out, "w", encoding="utf-8") as f:
        for row in flagged:
            f.write(json.dumps(row, ensure_ascii=False) + "\n")
    log.info("unique-spk: flagged %d clips → %s", len(flagged), args.out)


def single_wav_folders(root: str) -> list:
    """A top-down walk listing the folders whose own files hold exactly one
    .wav (prepare/delete_one_file_dir.py:6-19); a listed folder is not
    descended into, so deleting the list in order is safe."""
    out = []

    def walk(folder: pathlib.Path):
        if sum(p.is_file() and p.suffix == ".wav" for p in folder.iterdir()) == 1:
            out.append(str(folder))
            return
        for sub in sorted(p for p in folder.iterdir() if p.is_dir()):
            walk(sub)

    for top in sorted(p for p in pathlib.Path(root).iterdir() if p.is_dir()):
        walk(top)
    return out


def cmd_prune_single_wav(args):
    folders = single_wav_folders(args.root)
    pathlib.Path(args.out).write_text("\n".join(folders) + ("\n" if folders else ""))
    if args.delete:
        for f in folders:
            shutil.rmtree(f)
    log.info("prune-single-wav: %d folders %s → %s", len(folders),
             "deleted" if args.delete else "listed (dry-run)", args.out)


def cmd_do_to_files(args):
    mod_name, fn_name = args.fn.split(":")
    fn = getattr(importlib.import_module(mod_name), fn_name)
    with open(args.file_list) as f:
        paths = [line.strip() for line in f if line.strip()]
    with ProcessPoolExecutor(max_workers=args.workers) as pool:
        list(pool.map(fn, paths))
    log.info("do-to-files: processed %d files", len(paths))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("classify")
    s.add_argument("--manifest", required=True)
    s.add_argument("--ckpt", required=True,
                   help="a release .npz or a train.mains classifier checkpoint directory")
    s.add_argument("--out", required=True)
    s.add_argument("--config", default=None)
    s.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    s.set_defaults(run=cmd_classify)

    s = sub.add_parser("remove-empty")
    s.add_argument("--manifest", required=True)
    s.add_argument("--out", required=True)
    s.set_defaults(run=cmd_remove_empty)

    s = sub.add_parser("unique-spk")
    s.add_argument("--root", required=True, help="speaker-folder root")
    s.add_argument("--out", required=True, help="deletion jsonl")
    s.add_argument("--sv-hook", default=None,
                   help="module exposing same_speaker(ref, path)->bool")
    s.set_defaults(run=cmd_unique_spk)

    s = sub.add_parser("prune-single-wav")
    s.add_argument("--root", required=True)
    s.add_argument("--out", required=True, help="list of flagged folders")
    s.add_argument("--delete", action="store_true",
                   help="actually delete (default: dry-run list)")
    s.set_defaults(run=cmd_prune_single_wav)

    s = sub.add_parser("do-to-files")
    s.add_argument("--file-list", required=True)
    s.add_argument("--fn", required=True, help="module:function")
    s.add_argument("--workers", type=int, default=8)
    s.set_defaults(run=cmd_do_to_files)

    args = p.parse_args(argv)
    args.run(args)


if __name__ == "__main__":
    main()
