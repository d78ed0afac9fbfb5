"""The port's data preparation against the JAX package's, on the CPU:

- the host audio tools (load_wav, save_wav, resample_audio, vad_split) on
  the native path, which both packages take here since their copies of
  audio_io.cc build (bit-equal: the same C code), and on the fallbacks both
  take without it (stdlib WAV and the numpy VAD equal; the port's PyTorch
  resampler within 1e-5 of JAX's);
- every `pipeline` and `misc` subcommand, port against JAX, on one
  temporary corpus (the five-stage recipe's raw recordings) and the same
  codec and classifier weights (seeded, rounded to float16 so that the
  release `.npz` the port reads holds them exactly): identical clips,
  manifests, BPE corpora and filter lists, mel sidecars whose
  magnitudes agree within 1e-5 of their peak (MEL_REL), vq sidecars
  bit-identical (a clip of an odd frame count included: extract_code
  stops before enc_p_2, so it runs on both sides);
- parse_redactions.

JAX's `pipeline vq` restores its codec from an Orbax directory; the test
hands it the same variables through a stub CheckpointManager."""

import argparse
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ttts_tpu.data.audio as jaudio
import ttts_tpu.train.checkpoints as jcheckpoints
from test_five_stage_recipe import PINYIN, RECIPE_CFG, TEXTS, _make_raw_corpus
from test_torch_codec_synth import random_codec_variables, seeded_variables
from ttts_tpu.config import ClassifierConfig
from ttts_tpu.data.prepare import misc as jmisc
from ttts_tpu.data.prepare import pipeline as jpipeline
from ttts_tpu.models.classifier import AudioMiniEncoderWithClassifierHead as JClassifier
from ttts_tpu.text.alignment import parse_redactions as jparse_redactions
from ttts_tpu_torch import porting
from ttts_tpu_torch.config import to_dict
from ttts_tpu_torch.data import audio
from ttts_tpu_torch.data.manifest import load_sidecar, read_manifest, write_manifest
from ttts_tpu_torch.data.prepare import misc, pipeline
from ttts_tpu_torch.text.alignment import parse_redactions
from ttts_tpu_torch.train.checkpoints import export_model, export_release

# the mel sidecars hold log mels: their magnitudes (exp of the sidecar) agree
# within MEL_REL of the sidecar's peak magnitude. The port's f32 STFT and
# filterbank read 3e-7 to 5.4e-7 against JAX's on this corpus. The log
# itself is no measure: bins of near-silence (e^-11 in the 44.1 kHz clip's
# top band, cut twice by the resamplers) differ by up to 0.44 there, the
# log magnifying the f32 rounding of a tiny magnitude
MEL_REL = 1e-5
CLASSIFIER = ClassifierConfig(embedding_dim=64, depth=2, base_channels=16, attn_blocks=1,
                              num_attn_heads=2, kernel_size=3)
CFG = dataclasses.replace(RECIPE_CFG, classifier=CLASSIFIER)


def f16(tree):
    """Each leaf rounded to float16 and back (exact through a release .npz)."""
    return jax.tree_util.tree_map(lambda v: np.asarray(v, np.float16).astype(np.float32)
                                  if np.asarray(v).dtype == np.float32 else np.asarray(v), tree)


def _hook(mp: pytest.MonkeyPatch, tmp: pathlib.Path, name: str, body: str) -> str:
    """A module `name` in `tmp`, importable while `mp` holds."""
    (tmp / f"{name}.py").write_text(body)
    mp.syspath_prepend(str(tmp))
    return name


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The raw corpus (plus a 44.1 kHz recording), VAD'd by both packages,
    transcribed by both, and the config file both CLIs read."""
    d = tmp_path_factory.mktemp("prepare")
    _make_raw_corpus(d / "raw")
    rng = np.random.default_rng(3)
    t = np.arange(int(2.3 * 44100)) / 44100
    loud = (0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(len(t)))
    y = np.concatenate([np.zeros(40000), loud, np.zeros(40000)]).astype(np.float32)
    jaudio.save_wav(d / "raw" / "rec_44k.wav", y, 44100)
    jpipeline.main(["vad", "--in-dir", str(d / "raw"), "--out-dir", str(d / "clips_jax")])
    pipeline.main(["vad", "--in-dir", str(d / "raw"), "--out-dir", str(d / "clips")])
    texts = {i: TEXTS[i % len(TEXTS)] for i in range(64)}
    with pytest.MonkeyPatch.context() as mp:
        hook = _hook(mp, d, "prepare_asr_hook",
                     f"import pathlib\nTEXTS = {texts!r}\n"
                     "def transcribe(path):\n"
                     "    return TEXTS[sorted(p.name for p in pathlib.Path(path).parent.glob("
                     "'*.wav')).index(pathlib.Path(path).name)]\n")
        jpipeline.main(["asr", "--in-dir", str(d / "clips"), "--out",
                        str(d / "asr_jax.jsonl"), "--hook", hook])
        pipeline.main(["asr", "--in-dir", str(d / "clips"), "--out", str(d / "asr.jsonl"),
                       "--hook", hook])
    rows = [{**r, "text": PINYIN[r["text"]]} for r in read_manifest(d / "asr.jsonl")]
    write_manifest(d / "data.jsonl", rows)
    (d / "cfg.json").write_text(json.dumps(to_dict(CFG)))
    return d


def test_native_library_builds_in_both_packages():
    assert audio._native() is not None and jaudio._native() is not None


@pytest.mark.parametrize("rates", [(44100, 32000), (32000, 24000), (16000, 24000)])
def test_load_and_resample_native_equal(tmp_path, rates):
    orig, new = rates
    rng = np.random.default_rng(orig)
    x = (0.3 * rng.standard_normal(orig // 3 + 17)).astype(np.float32)
    np.testing.assert_array_equal(audio.resample_audio(x, orig, new),
                                  jaudio.resample_audio(x, orig, new))
    audio.save_wav(tmp_path / "port.wav", x, orig)
    jaudio.save_wav(tmp_path / "jax.wav", x, orig)
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()
    for sr in (None, new):
        got, got_sr = audio.load_wav(tmp_path / "port.wav", target_sr=sr)
        want, want_sr = jaudio.load_wav(tmp_path / "port.wav", target_sr=sr)
        assert got_sr == want_sr
        np.testing.assert_array_equal(got, want)
    assert audio.wav_frames(tmp_path / "port.wav", new) == jaudio.wav_frames(
        tmp_path / "port.wav", new)


def test_vad_split_native_equal(work):
    for path in sorted((work / "raw").glob("*.wav")):
        wav, sr = audio.load_wav(path, target_sr=32000)
        for kw in ({}, {"min_silence_ms": 200, "silence_thresh_db": -30.0, "keep_silence_ms": 0}):
            segs = audio.vad_split(wav, sr, **kw)
            assert segs == jaudio.vad_split(wav, sr, **kw) and segs


def test_fallbacks_equal(work, tmp_path, monkeypatch):
    """Without the native library: the stdlib WAV reader and writer, the
    numpy VAD (equal) and the resamplers (the port's PyTorch one against
    JAX's, 1e-5)."""
    monkeypatch.setattr(audio, "_native", lambda: None)
    monkeypatch.setattr(jaudio, "_native", lambda: None)
    path = work / "raw" / "rec_44k.wav"
    for sr in (None, 32000):
        got, _ = audio.load_wav(path, target_sr=sr)
        want, _ = jaudio.load_wav(path, target_sr=sr)
        np.testing.assert_allclose(got, want, atol=1e-5 if sr else 0, rtol=0)
    wav, _ = jaudio.load_wav(path, target_sr=32000)
    assert audio.vad_split(wav, 32000) == jaudio.vad_split(wav, 32000)
    audio.save_wav(tmp_path / "port.wav", wav, 32000)
    jaudio.save_wav(tmp_path / "jax.wav", wav, 32000)
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()


def test_vad_clips_identical(work):
    port = sorted((work / "clips").glob("*.wav"))
    assert [p.name for p in port] == [p.name for p in sorted((work / "clips_jax").glob("*.wav"))]
    assert len(port) >= 6 and any("44k" in p.name for p in port)
    for p in port:
        assert p.read_bytes() == (work / "clips_jax" / p.name).read_bytes()


def test_asr_manifest_identical(work):
    assert (work / "asr.jsonl").read_text() == (work / "asr_jax.jsonl").read_text()
    assert len(read_manifest(work / "asr.jsonl")) == len(list((work / "clips").glob("*.wav")))


def test_asr_without_hook_exits(work):
    with pytest.raises(SystemExit, match="--hook"):
        pipeline.main(["asr", "--in-dir", str(work / "clips"), "--out", str(work / "x.jsonl")])


def test_bpe_corpus_identical(work):
    pipeline.main(["bpe-corpus", str(work / "data.jsonl"), "--out", str(work / "bpe.txt")])
    jpipeline.main(["bpe-corpus", str(work / "data.jsonl"), "--out", str(work / "bpe_jax.txt")])
    assert (work / "bpe.txt").read_text() == (work / "bpe_jax.txt").read_text()


def test_mel_sidecars_within_limit(work):
    manifest = str(work / "data.jsonl")
    rows = read_manifest(manifest)
    jpipeline.main(["mel", "--manifest", manifest])
    want = [load_sidecar(r["path"], "mel") for r in rows]
    pipeline.main(["mel", "--manifest", manifest, "--device", "cpu"])
    for r, w in zip(rows, want):
        got = load_sidecar(r["path"], "mel")
        assert got.shape == w.shape and got.shape[0] == 100 and got.dtype == np.float32
        assert np.abs(np.exp(got) - np.exp(w)).max() <= MEL_REL * np.exp(w).max()


def test_vq_sidecars_bit_identical(work, monkeypatch):
    """A clip of an odd frame count at the codec's hop (one: JAX's pipeline
    compiles extract_code once per clip length, ~13 s here)."""
    _, variables = random_codec_variables(seed=7)
    st = variables["codebook"]["quantizer"]["state"]
    variables = f16({"params": variables["params"], "codebook": {"quantizer": {"state": {
        "embed": st.embed, "embed_avg": st.embed_avg, "cluster_size": st.cluster_size,
        "inited": np.asarray(True)}}}})
    export_release(variables, work / "codec.npz")
    hop = CFG.audio.hop_length
    rows = read_manifest(work / "data.jsonl")
    frames = [audio.wav_frames(r["path"]) // hop for r in rows]
    odd = next(i for i, f in enumerate(frames) if f % 2)
    pick = [rows[odd]]
    write_manifest(work / "vq.jsonl", pick)

    class Restored:
        def __init__(self, directory):
            pass

        def restore(self):
            return 0, variables

    monkeypatch.setattr(jcheckpoints, "CheckpointManager", Restored)
    base = ["vq", "--manifest", str(work / "vq.jsonl"), "--config", str(work / "cfg.json")]
    jpipeline.main([*base, "--ckpt", "orbax-dir"])
    want = [load_sidecar(r["path"], "vq") for r in pick]
    pipeline.main([*base, "--ckpt", str(work / "codec.npz"), "--device", "cpu"])
    for r, w in zip(pick, want):
        got = load_sidecar(r["path"], "vq")
        assert got.dtype == np.int32 and got.shape == w.shape
        np.testing.assert_array_equal(got, w)
    assert load_sidecar(pick[0]["path"], "vq").shape == (frames[odd] // 2,)


def test_mel_and_vq_run_on_the_card_by_default(work):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.main(["mel", "--manifest", str(work / "data.jsonl")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        misc.main(["classify", "--manifest", str(work / "data.jsonl"), "--ckpt", "x.npz",
                   "--out", str(work / "x.txt")])


def test_filters_identical(work):
    manifest = str(work / "data.jsonl")
    rows = read_manifest(manifest)
    (work / "noise.txt").write_text(rows[0]["path"] + "\n" + rows[2]["path"] + "\n")
    for mod, out in ((pipeline, "kept.jsonl"), (jpipeline, "kept_jax.jsonl")):
        mod.main(["filter-noise", "--manifest", manifest, "--noise-files",
                  str(work / "noise.txt"), "--out", str(work / out)])
    assert (work / "kept.jsonl").read_text() == (work / "kept_jax.jsonl").read_text()
    assert len(read_manifest(work / "kept.jsonl")) == len(rows) - 2
    for mod, out in ((pipeline, "hifreq.txt"), (jpipeline, "hifreq_jax.txt")):
        mod.main(["filter-nohifreq", "--manifest", manifest, "--out", str(work / out)])
    assert (work / "hifreq.txt").read_text() == (work / "hifreq_jax.txt").read_text()


def test_classify_identical(work):
    """The same classifier weights (an export of the port's state dict,
    which JAX's load_model reads too) flag the same clips (four: JAX's
    classifier runs op by op)."""
    variables = f16(seeded_variables(
        lambda: JClassifier(CLASSIFIER).init(jax.random.key(0), jnp.zeros((1, 64, 100))), seed=5))
    export_model("classifier", porting.classifier_state_dict(variables), work / "cls.npz")
    write_manifest(work / "cls.jsonl", read_manifest(work / "data.jsonl")[:4])
    base = ["classify", "--manifest", str(work / "cls.jsonl"), "--ckpt", str(work / "cls.npz"),
            "--config", str(work / "cfg.json")]
    jmisc.main([*base, "--out", str(work / "noise_jax.txt")])
    misc.main([*base, "--out", str(work / "noise_files.txt"), "--device", "cpu"])
    assert (work / "noise_files.txt").read_text() == (work / "noise_jax.txt").read_text()


@pytest.fixture
def speakers(tmp_path):
    """Speaker folders: two of three clips, one of one, one nested folder of
    one clip inside a folder of two, an empty one; a manifest with a
    missing and an empty file."""
    root = tmp_path / "spk"
    for spk, n in (("a", 3), ("b", 3), ("c", 1), ("d", 2), ("d/inner", 1), ("e", 0)):
        (root / spk).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            audio.save_wav(root / spk / f"{i}.wav", np.full(800, 0.1, np.float32), 16000)
    (root / "a" / "empty.wav").write_bytes(b"")
    rows = [{"text": "x", "path": str(p)} for p in sorted(root.rglob("*.wav"))]
    rows.append({"text": "x", "path": str(root / "missing.wav")})
    write_manifest(tmp_path / "m.jsonl", rows)
    return tmp_path


def test_remove_empty_identical(speakers):
    for mod, out in ((misc, "kept.jsonl"), (jmisc, "kept_jax.jsonl")):
        mod.main(["remove-empty", "--manifest", str(speakers / "m.jsonl"), "--out",
                  str(speakers / out)])
    kept = (speakers / "kept.jsonl").read_text()
    assert kept == (speakers / "kept_jax.jsonl").read_text()
    names = [pathlib.Path(r["path"]).name for r in read_manifest(speakers / "kept.jsonl")]
    assert len(names) == 10 and "missing.wav" not in names and "empty.wav" not in names


def test_unique_spk_identical(speakers, monkeypatch):
    hook = _hook(monkeypatch, speakers, "prepare_sv_hook",
                 "def same_speaker(ref, path):\n"
                 "    return path.endswith('0.wav') or ref.endswith(path[-5:])\n")
    for mod, out in ((misc, "del.jsonl"), (jmisc, "del_jax.jsonl")):
        mod.main(["unique-spk", "--root", str(speakers / "spk"), "--out", str(speakers / out),
                  "--sv-hook", hook])
    got = (speakers / "del.jsonl").read_text()
    assert got == (speakers / "del_jax.jsonl").read_text()
    reasons = [json.loads(line)["reason"] for line in got.splitlines()]
    assert "single-clip-folder" in reasons and "speaker-mismatch" in reasons
    with pytest.raises(SystemExit, match="--sv-hook"):
        misc.main(["unique-spk", "--root", str(speakers / "spk"), "--out", "x"])


def test_prune_single_wav_identical(speakers):
    root = str(speakers / "spk")
    for mod, out in ((misc, "single.txt"), (jmisc, "single_jax.txt")):
        mod.main(["prune-single-wav", "--root", root, "--out", str(speakers / out)])
    listed = (speakers / "single.txt").read_text()
    assert listed == (speakers / "single_jax.txt").read_text()
    assert listed.split() == [str(speakers / "spk" / "c"), str(speakers / "spk" / "d" / "inner")]
    misc.main(["prune-single-wav", "--root", root, "--out", str(speakers / "x.txt"), "--delete"])
    assert not (speakers / "spk" / "c").exists() and (speakers / "spk" / "d" / "0.wav").exists()


def test_do_to_files_identical(speakers, monkeypatch):
    """JAX's CLI cannot run it (its --fn overwrites the parser's dispatch
    `fn`: ROADMAP.md queue 3), so JAX's cmd_do_to_files is called with the
    arguments the port's CLI parses."""
    hook = _hook(monkeypatch, speakers, "prepare_files_hook",
                 "import pathlib\n"
                 "def mark(path):\n"
                 "    pathlib.Path(path + '.done').write_text(pathlib.Path(path).name)\n")
    paths = sorted(str(p) for p in (speakers / "spk").rglob("*.wav"))
    (speakers / "list.txt").write_text("\n".join(paths) + "\n")
    args = ["do-to-files", "--file-list", str(speakers / "list.txt"), "--fn", f"{hook}:mark",
            "--workers", "2"]
    with pytest.raises(TypeError, match="not callable"):
        jmisc.main(args)
    runs = (lambda: misc.main(args),
            lambda: jmisc.cmd_do_to_files(argparse.Namespace(
                file_list=str(speakers / "list.txt"), fn=f"{hook}:mark", workers=2)))
    for run in runs:
        for p in paths:
            pathlib.Path(p + ".done").unlink(missing_ok=True)
        run()
        assert all(pathlib.Path(p + ".done").read_text() == pathlib.Path(p).name
                   for p in paths)


@pytest.mark.parametrize("text", ["hello [world] x", "no brackets", "[a] and [b c]", "[]", "a [b"])
def test_parse_redactions_equal(text):
    assert parse_redactions(text) == jparse_redactions(text)
