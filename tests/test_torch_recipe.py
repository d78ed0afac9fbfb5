"""The five-stage recipe through the port's own CLIs, on the CPU (--device
cpu), at tests/test_five_stage_recipe.py's RECIPE_CFG widths (a small
classifier added: RECIPE_CFG leaves the default one): each stage reads what
the one before it wrote.

  1. pipeline vad, asr (an injected transcribe hook) and bpe-corpus;
  2. train.mains vqvae (the codec GAN);
  3. pipeline mel and vq, vq from stage 2's checkpoint directory;
  4. train.mains gpt on the vq sidecars;
  5. train.mains clvp on them;
  6. train.mains diffusion against stage 4's frozen GPT;
  7. train.mains classifier on clean / noise lists of the mel sidecars, then
     misc classify with its export, then pipeline filter-noise;
  8. TextToSpeech.from_checkpoints serving a finite waveform from the
     exports of stages 2, 4, 5 and 6 (preset "fast": the CLVP reranks).

The raw corpus and the pinyin substitution (the image has no pypinyin) are
the JAX recipe test's; nothing of the JAX package runs here."""

import dataclasses
import json

import numpy as np

from test_five_stage_recipe import PINYIN, RECIPE_CFG, SR, TEXTS, _make_raw_corpus
from ttts_tpu.config import ClassifierConfig
from ttts_tpu_torch.config import to_dict
from test_torch_vqvae_train import torch_threads  # noqa: F401 (autouse)
from ttts_tpu_torch.data.manifest import load_sidecar, read_manifest, write_manifest
from ttts_tpu_torch.data.prepare import misc, pipeline
from ttts_tpu_torch.train import mains
from ttts_tpu_torch.train.checkpoints import CheckpointManager, export_model, trained_state_dict

CFG = dataclasses.replace(RECIPE_CFG, classifier=ClassifierConfig(
    embedding_dim=64, depth=2, base_channels=16, attn_blocks=1, num_attn_heads=2,
    kernel_size=3, pad_to_mel_frames=64))


def test_recipe_through_the_port_clis(tmp_path, monkeypatch):
    from ttts_tpu_torch.api import TextToSpeech
    from test_torch_config import to_port

    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(to_dict(CFG)))
    cfg = to_port(CFG)
    dev = ["--device", "cpu"]

    # 1. vad → asr → bpe-corpus
    _make_raw_corpus(tmp_path / "raw")
    clips = tmp_path / "clips"
    pipeline.main(["vad", "--in-dir", str(tmp_path / "raw"), "--out-dir", str(clips)])
    n = len(list(clips.glob("*.wav")))
    assert n >= 4
    (tmp_path / "torch_recipe_asr_hook.py").write_text(
        f"TEXTS = {TEXTS!r}\n"
        "def transcribe(path):\n"
        "    return TEXTS[sum(map(ord, path)) % len(TEXTS)]\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    manifest = tmp_path / "data.jsonl"
    pipeline.main(["asr", "--in-dir", str(clips), "--out", str(manifest),
                   "--hook", "torch_recipe_asr_hook"])
    rows = [{**r, "text": PINYIN[r["text"]]} for r in read_manifest(manifest)]
    assert len(rows) == n
    write_manifest(manifest, rows)
    pipeline.main(["bpe-corpus", str(manifest), "--out", str(tmp_path / "bpe.txt")])
    assert len((tmp_path / "bpe.txt").read_text().splitlines()) == n

    def train(model, logs, *args):
        mains.main([model, "--config", str(cfg_path), "--logs", str(tmp_path / logs),
                    *args, *dev])
        assert CheckpointManager(tmp_path / logs / "ckpt").latest_step() == CFG.train.train_steps

    # 2. the codec GAN; 3. mel and vq sidecars through its checkpoint
    train("vqvae", "logs_vqvae", "--manifest", str(manifest))
    pipeline.main(["mel", "--manifest", str(manifest), *dev])
    pipeline.main(["vq", "--manifest", str(manifest), "--ckpt", str(tmp_path / "logs_vqvae"),
                   "--config", str(cfg_path), *dev])
    for r in rows:
        codes, mel = load_sidecar(r["path"], "vq"), load_sidecar(r["path"], "mel")
        assert codes.dtype == np.int32 and 0 <= codes.min() and codes.max() < 32
        assert mel.shape[0] == 100 and np.isfinite(mel).all()

    # 4-6. GPT, CLVP, diffusion on the sidecars
    train("gpt", "logs_gpt", "--manifest", str(manifest))
    train("clvp", "logs_clvp", "--manifest", str(manifest))
    train("diffusion", "logs_diff", "--manifest", str(manifest), "--gpt-ckpt",
          str(tmp_path / "logs_gpt" / "ckpt"))

    # 7. classifier → classify → filter-noise
    paths = [r["path"] for r in rows]
    (tmp_path / "clean.txt").write_text("\n".join(paths[: n // 2]) + "\n")
    (tmp_path / "noise.txt").write_text("\n".join(paths[n // 2:]) + "\n")
    train("classifier", "logs_cls", "--clean", str(tmp_path / "clean.txt"), "--noise",
          str(tmp_path / "noise.txt"))
    exports = {}
    for name, logs in (("classifier", "logs_cls"), ("vqvae", "logs_vqvae"), ("gpt", "logs_gpt"),
                       ("clvp", "logs_clvp"), ("diffusion", "logs_diff")):
        exports[name] = tmp_path / f"{name}.npz"
        export_model(name, trained_state_dict(name, tmp_path / logs)[0], exports[name])
    noise_files = tmp_path / "noise_files.txt"
    misc.main(["classify", "--manifest", str(manifest), "--ckpt", str(exports["classifier"]),
               "--out", str(noise_files), "--config", str(cfg_path), *dev])
    flagged = [line for line in noise_files.read_text().splitlines() if line]
    assert set(flagged) <= set(paths)
    pipeline.main(["filter-noise", "--manifest", str(manifest), "--noise-files",
                   str(noise_files), "--out", str(tmp_path / "clean.jsonl")])
    assert len(read_manifest(tmp_path / "clean.jsonl")) == n - len(flagged)

    # 8. serve from the exports
    tts = TextToSpeech.from_checkpoints(cfg, codec=exports["vqvae"], gpt=exports["gpt"],
                                        diffusion=exports["diffusion"], clvp=exports["clvp"],
                                        device="cpu")
    voice = (np.random.default_rng(0).standard_normal(SR) * 0.1).astype(np.float32)
    wav = tts.tts("ni3 hao3 shi4 jie4", voice, SR, preset="fast", max_generate_length=32)
    assert wav.ndim == 1 and wav.shape[0] > 1000 and np.isfinite(wav).all()
