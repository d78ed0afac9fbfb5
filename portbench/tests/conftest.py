"""Fixtures of the benchmark's CPU tests: a benchmark root at TINY widths
(BENCHMARK.json with the real cells' traffic and limits, the configurations
cut to TINY), and the `card` fixture that skips a test without a card."""

from __future__ import annotations

import dataclasses
import json
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]


def tiny_ttts() -> dict:
    """The port's configuration tree at TINY widths (tests/test_api.py's)."""
    from ttts_tpu_torch.config import (AcousticMelConfig, AudioConfig, CLVPConfig,
                                       DiffusionNetConfig, GPTConfig, TrainConfig,
                                       TTTSConfig, VocosConfig, VQVAEConfig)

    cfg = TTTSConfig(
        audio=AudioConfig(sampling_rate=32000, filter_length=1024, hop_length=640,
                          win_length=1024, n_mel_channels=32),
        acoustic_mel=AcousticMelConfig(sample_rate=24000, n_fft=256, hop_length=256,
                                       n_mels=100),
        vqvae=VQVAEConfig(inter_channels=16, hidden_channels=16, filter_channels=32,
                          n_heads=2, n_layers=2, p_dropout=0.0, upsample_initial_channel=32,
                          gin_channels=16, codebook_bins=32, posterior_wn_layers=2,
                          flow_layers=1, flow_wn_layers=1),
        gpt=GPTConfig(model_dim=64, layers=1, heads=2, max_text_tokens=64, max_mel_tokens=128,
                      number_mel_codes=1026, start_mel_token=1024, stop_mel_token=1025),
        diffusion_net=DiffusionNetConfig(in_channels=100, out_channels=200, model_channels=64,
                                         num_heads=4, num_layers=1, in_latent_channels=64),
        clvp=CLVPConfig(dim_text=32, dim_speech=32, dim_latent=16, num_text_tokens=256,
                        num_speech_tokens=1026, text_enc_depth=1, speech_enc_depth=1,
                        text_heads=2, speech_heads=2),
        vocos=VocosConfig(input_channels=100, dim=32, intermediate_dim=96, num_layers=1,
                          n_fft=1024, hop_length=256),
        train=TrainConfig(segment_size=640 * 4))
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


TINY_SERVE = dict(max_generate_length=16, voice_seconds=1.0, voice_rate=32000, check_calls=2,
                  check_texts=2, trace_units=1)
TINY_CYCLE = [{"text": [10, 12, 8, 9], "mel": [20, 24, 17, 30], "text_pad": 16, "mel_pad": 32},
              {"text": [5, 6], "mel": [30, 40], "text_pad": 16, "mel_pad": 64}]


def write_tiny_root(out: pathlib.Path) -> pathlib.Path:
    """BENCHMARK.json and the cells' files under `out`, each configuration
    cut to TINY and each traffic to a few short requests; limits as the
    real cells'. Training computes in f32 here, as serving on the CPU does,
    so a sound run reads the reference's arithmetic and a fault stands out."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (out / "portbench" / "configs").mkdir(parents=True, exist_ok=True)
    (out / "portbench" / "workloads").mkdir(parents=True, exist_ok=True)
    ttts = tiny_ttts()
    for c in bench["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        tiny = json.loads(json.dumps(ttts))
        tiny["gpt"].update({k: data["ttts"]["gpt"][k]
                            for k in ("flash_attention", "attn_dropout", "dropout")})
        data["ttts"] = tiny
        if "compute_dtype" in data:  # on the CPU the program computes as the reference
            data["compute_dtype"] = "float32"
        (out / c["file"]).write_text(json.dumps(data))
    for w in bench["workloads"]:
        path = pathlib.Path("portbench") / "workloads" / f"{w['name']}.json"
        data = json.loads((ROOT / path).read_text())
        if data["kind"] == "serve_batch":
            data["params"].update(TINY_SERVE, texts_per_call=2 + data["params"]["candidates"] % 3)
        else:
            data["params"].update(cycle=TINY_CYCLE, trace_units=2)
        (out / path).write_text(json.dumps(data))
    (out / "BENCHMARK.json").write_text(json.dumps(bench))
    return out


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return write_tiny_root(tmp_path_factory.mktemp("tiny_bench"))


@pytest.fixture
def card():
    """The card, decided here (never at import): skips without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
