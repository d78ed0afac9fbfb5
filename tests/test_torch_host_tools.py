"""The port's host tools around third-party code against the JAX package's
on the CPU: the HuBERT sidecar CLI and the wav2vec2 aligner on tiny,
randomly initialised local checkpoints (HubertModel / Wav2Vec2ForCTC
written with save_pretrained, with a local CTC vocabulary: nothing is
downloaded), the spider's parsers, crawlers, downloader (file:// URLs) and
duration count, profile_trace and plot_spectrogram_to_numpy. Both packages
run the same torch model on the same files, so the sidecars, spans and
redacted audio must be equal (within 1e-6 where a float is compared)."""

import json
import shutil
import sys

import numpy as np
import pytest
import torch

import ttts_tpu.data.spider as jspider
from test_spider import PLAYERFM_HTML, XMLY_PAGE1, XMLY_PAGE2
from ttts_tpu.data.prepare import hubert as jhubert
from ttts_tpu.text.alignment import Wav2VecAlignment as JWav2VecAlignment
from ttts_tpu.utils import logging as jlogging
from ttts_tpu_torch.data import audio, spider
from ttts_tpu_torch.data.manifest import load_sidecar, write_manifest
from ttts_tpu_torch.data.prepare import hubert
from ttts_tpu_torch.text.alignment import Wav2VecAlignment
from ttts_tpu_torch.utils import logging as plogging

transformers = pytest.importorskip("transformers")

VOCAB = ["<pad>", "<s>", "</s>", "<unk>", "|"] + [chr(c) for c in range(ord("a"), ord("z") + 1)]


def _wavs(root, n=2, sr=22050):
    """n seeded voice-like clips of 0.4-0.6 s at `sr` and their manifest."""
    root.mkdir(parents=True, exist_ok=True)
    rows = []
    for i in range(n):
        rng = np.random.default_rng(i)
        t = np.arange(int((0.4 + 0.1 * i) * sr)) / sr
        wav = 0.3 * np.sin(2 * np.pi * (150 + 40 * i) * t) + 0.02 * rng.standard_normal(t.size)
        path = root / f"c{i}.wav"
        audio.save_wav(path, wav.astype(np.float32), sr)
        rows.append({"text": "x", "path": str(path)})
    write_manifest(root / "m.jsonl", rows)
    return root / "m.jsonl", rows


@pytest.fixture(scope="module")
def hubert_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("hubert")
    torch.manual_seed(0)
    cfg = transformers.HubertConfig(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                                    intermediate_size=64, conv_dim=(16, 16), conv_stride=(5, 4),
                                    conv_kernel=(10, 4), num_conv_pos_embeddings=16,
                                    num_conv_pos_embedding_groups=4)
    transformers.HubertModel(cfg).save_pretrained(d)
    transformers.Wav2Vec2FeatureExtractor(do_normalize=True).save_pretrained(d)
    return str(d)


def test_hubert_sidecars_match_jax(hubert_dir, tmp_path):
    """The CLI writes each clip's `.hubert.npy` (resampled to 16 kHz), equal
    to the JAX package's CLI's on a copy of the same clips."""
    manifest, rows = _wavs(tmp_path / "port")
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    jrows = [{**r, "path": r["path"].replace("/port/", "/jax/")} for r in rows]
    write_manifest(tmp_path / "jax" / "m.jsonl", jrows)
    hubert.main(["--manifest", str(manifest), "--model-dir", hubert_dir, "--device", "cpu"])
    jhubert.main(["--manifest", str(tmp_path / "jax" / "m.jsonl"), "--model-dir", hubert_dir])
    for r, jr in zip(rows, jrows):
        got, want = load_sidecar(r["path"], "hubert"), load_sidecar(jr["path"], "hubert")
        assert got.dtype == np.float32 and got.shape == want.shape and got.shape[1] == 32
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_hubert_defaults_to_the_card(hubert_dir, tmp_path):
    """Without --device the CLI asks for the card (none here), and
    extract_hubert returns the model's last hidden states."""
    manifest, _ = _wavs(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hubert.main(["--manifest", str(manifest), "--model-dir", hubert_dir])
    model, extractor = hubert.get_hubert_model(hubert_dir, "cpu")
    wav = np.random.default_rng(3).standard_normal(8000).astype(np.float32)
    jmodel, jextractor = jhubert.get_hubert_model(hubert_dir)
    np.testing.assert_allclose(hubert.extract_hubert(model, extractor, wav),
                               jhubert.extract_hubert(jmodel, jextractor, wav), atol=1e-6)


def test_missing_transformers_is_named(hubert_dir, monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        hubert.get_hubert_model(hubert_dir, "cpu")
    with pytest.raises(ImportError, match="transformers"):
        Wav2VecAlignment(hubert_dir, device="cpu")


@pytest.fixture(scope="module")
def aligner_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("wav2vec2")
    (d / "vocab.json").write_text(json.dumps({c: i for i, c in enumerate(VOCAB)}))
    tok = transformers.Wav2Vec2CTCTokenizer(str(d / "vocab.json"), word_delimiter_token="|")
    fe = transformers.Wav2Vec2FeatureExtractor(do_normalize=True)
    transformers.Wav2Vec2Processor(feature_extractor=fe, tokenizer=tok).save_pretrained(d)
    torch.manual_seed(1)
    cfg = transformers.Wav2Vec2Config(vocab_size=len(VOCAB), hidden_size=32,
                                      num_hidden_layers=2, num_attention_heads=2,
                                      intermediate_size=64, conv_dim=(16, 16),
                                      conv_stride=(5, 4), conv_kernel=(10, 4),
                                      num_conv_pos_embeddings=16,
                                      num_conv_pos_embedding_groups=4)
    model = transformers.Wav2Vec2ForCTC(cfg)
    with torch.no_grad():  # spread the argmax over the characters
        model.lm_head.weight.mul_(50.0)
    model.save_pretrained(d)
    return str(d)


def test_alignment_matches_jax(aligner_dir):
    """Spans equal to the JAX aligner's, and the redaction of a bracketed
    word (one the greedy alignment spells) cuts the same samples."""
    rng = np.random.default_rng(4)
    wav = (0.3 * rng.standard_normal(16000)).astype(np.float32)
    port = Wav2VecAlignment(aligner_dir, device="cpu")
    ref = JWav2VecAlignment(aligner_dir)
    spans = port.align(wav, "ignored")
    assert spans == ref.align(wav, "ignored") and len(spans) >= 4
    word = "".join(ch for _, _, ch in spans[1:4] if ch.isalnum())
    text = f"before [{word}] after"
    got, want = port.redact(wav, text), ref.redact(wav, text)
    assert len(got) < len(wav)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port.redact(wav, "no brackets"), wav)


def test_spider_parsers_and_crawlers():
    """tests/test_spider.py's fixture pages through both packages."""
    assert spider.extract_playerfm_audio_urls(PLAYERFM_HTML) == \
        jspider.extract_playerfm_audio_urls(PLAYERFM_HTML)
    for page, n in ((XMLY_PAGE1, 2), (XMLY_PAGE2, 3)):
        assert spider.parse_xmly_album_links(page) == jspider.parse_xmly_album_links(page)
        assert spider.parse_xmly_next_page(page, n) == jspider.parse_xmly_next_page(page, n)
    pages = {"https://www.ximalaya.com/category/a1001": XMLY_PAGE1,
             "https://www.ximalaya.com/category/a1001?page=2": XMLY_PAGE2}
    for num_pages in (1, 2, 50):
        got = spider.crawl_xmly("https://www.ximalaya.com/category/a1001", pages.__getitem__,
                                num_pages)
        assert got == jspider.crawl_xmly("https://www.ximalaya.com/category/a1001",
                                         pages.__getitem__, num_pages)
    seen = []
    urls = spider.crawl_playerfm("https://zh.player.fm/series/x",
                                 lambda u: seen.append(u) or PLAYERFM_HTML)
    assert seen == ["https://zh.player.fm/series/x"] and len(urls) == 3


def test_spider_download_and_duration(tmp_path, capsys):
    """download of local file:// URLs (a missing one logged and skipped),
    then total_duration and the CLI's count, equal to the JAX package's."""
    _, rows = _wavs(tmp_path / "src", n=3)
    urls = [f"file://{r['path']}" for r in rows] + [f"file://{tmp_path}/missing.wav"]
    (tmp_path / "urls.txt").write_text("\n".join(urls) + "\n")
    spider.main(["download", "--url-list", str(tmp_path / "urls.txt"),
                 "--out-dir", str(tmp_path / "got")])
    written = sorted(p.name for p in (tmp_path / "got").iterdir())
    assert written == ["c0.wav", "c1.wav", "c2.wav"]
    got = spider.total_duration(str(tmp_path / "got"))
    assert got == pytest.approx(jspider.total_duration(str(tmp_path / "src")), abs=1e-9)
    assert got == pytest.approx(0.4 + 0.5 + 0.6, abs=1e-3)
    spider.main(["duration", "--dir", str(tmp_path / "got")])
    assert capsys.readouterr().out.strip() == f"{got:.1f} seconds"


def test_profile_trace(tmp_path):
    """A Chrome trace of the block under logdir; None traces nothing."""
    with plogging.profile_trace(None) as prof:
        assert prof is None
    with plogging.profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "trace").glob("trace_*.json"))
    assert prof is not None and len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_plot_spectrogram_to_numpy():
    spec = np.random.default_rng(5).standard_normal((80, 40)).astype(np.float32)
    got = plogging.plot_spectrogram_to_numpy(spec)
    assert got.dtype == np.uint8 and got.ndim == 3 and got.shape[2] == 3
    np.testing.assert_array_equal(got, jlogging.plot_spectrogram_to_numpy(spec))
    np.testing.assert_array_equal(plogging.plot_spectrogram_to_numpy(spec.T), got)
