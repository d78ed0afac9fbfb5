"""The cell serve.moonlight.fast.b16 at TINY widths on the CPU (the trunk
cut to 2 layers of width 64, 8 experts, top 2): a whole traced run against
the plain reference, the layer-at-a-time weight draw against one whole
draw, and the grouped experts' work and the trunk's FLOPs against hand
counts at the published widths."""

from __future__ import annotations

import json

import pytest
import torch

from conftest import ROOT, TINY_SERVE, write_tiny_root
from portbench import flops_mla_moe
from portbench import run as bench
from portbench import weights as wts

CELL = "serve.moonlight.fast.b16"
SEED = 2 ** 31 + 91
TINY_LM = dict(hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
               num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
               kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=8, v_head_dim=8,
               n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
               max_position_embeddings=512)
PUBLISHED = json.loads((ROOT / "portbench/configs/moonlight_tts_serve.json").read_text())


@pytest.fixture(scope="module")
def lm_root(tmp_path_factory):
    root = write_tiny_root(tmp_path_factory.mktemp("tiny_lm"))
    path = root / "portbench/configs/moonlight_tts_serve.json"
    cfg = json.loads(path.read_text())
    cfg.update(TINY_LM)
    cfg["ttts"]["gpt"].update(heads=4, layers=2)
    path.write_text(json.dumps(cfg))
    path = root / "portbench/workloads" / f"{CELL}.json"
    work = json.loads(path.read_text())
    work["params"].update(TINY_SERVE, texts_per_call=2)
    path.write_text(json.dumps(work))
    return root


def test_traced_run_agrees_with_the_reference(lm_root):
    """f32 on the CPU: the program and the reference agree to round-off,
    every routed choice the reference's own."""
    out = bench.run(["--workload", CELL, "--seed", str(SEED), "--seconds", "0.5", "--trace",
                     "1"], root=lm_root, require_card=False)
    assert out["correct"] is True
    assert set(out["checks"]) == {"decode_gap", "latent_rel", "mel_rel", "wav_rel", "clvp_rel"}
    assert all(c["value"] <= 1e-4 for c in out["checks"].values())
    assert "serve.moe.mfu" in out["metrics"] and out["metrics"]["serve.moe.mfu"]["value"] > 0
    # no device trace on the CPU: the kernel's readers find nothing
    assert "serve.roofline.moe_experts" not in out["metrics"]
    assert "serve.moe.experts_ms_per_step" not in out["metrics"]


def test_control_is_not_correct(lm_root):
    found = bench.find_cell(lm_root, CELL)
    kind = bench.load(bench.PKG / "traffic" / "serve_batch_lm.py", "kind_control_lm")
    ctx = bench.context(found, SEED, torch.device("cpu"))
    kind.setup(ctx)
    readings = kind.control(ctx, [kind.unit(ctx, i) for i in range(2)])
    assert any(readings[k] > v for k, v in found.workload["limits"].items())


def test_layer_draws_against_one_whole_draw(lm_root):
    """The layer-at-a-time draw covers the whole model's keys and shapes,
    the same each time, by the same rule as one whole draw (the router's
    matrix at its own fan-in)."""
    from ttts_tpu_torch.api import TextToSpeech
    from ttts_tpu_torch.config import MLAMoEConfig

    found = bench.find_cell(lm_root, CELL)
    kind = bench.load(bench.PKG / "traffic" / "serve_batch_lm.py", "kind_draw_lm")
    ctx = bench.context(found, SEED, torch.device("cpu"))
    tts = TextToSpeech(kind.sb.port_config(found.config), device="cpu", seed=0,
                       trunk=MLAMoEConfig.from_published(found.config))
    gpt = tts.gpt
    with torch.no_grad():
        kind.load_gpt(ctx, gpt)
    layered = {k: v.clone() for k, v in gpt.state_dict().items()}
    whole = wts.make_state(wts.shapes_of(gpt), SEED, "gpt", "cpu")
    assert {k: tuple(v.shape) for k, v in layered.items()} == {
        k: tuple(v.shape) for k, v in whole.items()}
    with torch.no_grad():
        kind.load_gpt(ctx, gpt)
    assert all(torch.equal(v, gpt.state_dict()[k]) for k, v in layered.items())
    for k, v in layered.items():
        if v.dim() < 2 or "head" in k or k.endswith("gate.weight"):
            continue
        assert float(v.std() / whole[k].std()) == pytest.approx(1.0, abs=0.25), k
    router = layered["gpt.h.1.mlp.gate.weight"]
    assert float(router.std()) == pytest.approx(64 ** -0.5, rel=0.25)
    assert not layered["gpt.h.1.mlp.gate.e_score_correction_bias"].any()


def test_expert_work_hand_counts():
    work = bench.roofline("moe_experts").work(384, 60, 2048, 1408)
    assert work["flop"] == 6 * 2048 * 1408 * 384
    assert work["bytes"] == 60 * 3 * 2048 * 1408 * 2 + 384 * (2048 * 2 + 1408 * 2 * 2
                                                              + 2048 * 4 + 4)
    assert 3 * 2048 * 1408 * 2 == 17_301_504  # an expert's bytes, 17.3 MB


def test_trunk_flops_hand_counts():
    c = PUBLISHED
    attention = 2048 * 16 * 192 + 2048 * 576 + 512 * 16 * 256 + 16 * 128 * 2048
    assert attention == 13_762_560
    assert flops_mla_moe.ffn_params(c, 0) == 3 * 2048 * 11264
    assert flops_mla_moe.ffn_params(c, 1) == 2048 * 64 + 3 * 2048 * 1408 * (6 + 2)
    active = 27 * attention + 3 * 2048 * 11264 + 26 * (2048 * 64 + 3 * 2048 * 1408 * 8)
    assert flops_mla_moe.token_params(c) == active
    assert flops_mla_moe.forward(c, 1, 1) == 2.0 * active + 2.0 * 16 * 320 * 27
    assert flops_mla_moe.decode_step(c, 2, 10) == 2 * (2.0 * active + 2.0 * 16 * 1088 * 27 * 10)
