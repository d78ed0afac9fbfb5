"""The MLA-MoE trunk of UnifiedVoice (models/mla_moe.py) against the plain
f32 reference (portbench/reference/mla_moe.py) at a tiny size on the CPU,
on seeded random weights: prefill then decode through the latent cache
against the reference's full forward (logits), the absorbed decode against
the full form, the MoE layer and the grouped experts' plain version, the
whole serving call with the tiny trunk, and the settings that must raise.

Tolerances: both sides compute in f32 on the CPU, and differ only in the
order of their sums (the absorbed form's products, the grouped experts'
per-expert products against the reference's gathered ones), so agreement
is to f32 round-off over a few layers: 1e-4 relative (the f32 epsilon
1.2e-7 times the ~1e3 terms a logit sums, with room). The serving call is
checked for shape, finiteness and the path it took, not for values (its
draws come from its own generator)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from portbench.reference import mla_moe as ref
from ttts_tpu_torch.config import (AcousticMelConfig, AudioConfig, CLVPConfig,
                                   DiffusionNetConfig, GPTConfig, MLAMoEConfig, TTTSConfig,
                                   VocosConfig, VQVAEConfig)
from ttts_tpu_torch.models import gpt as gpt_mod
from ttts_tpu_torch.models import mla_moe
from ttts_tpu_torch.ops.cuda import moe

RTOL = 1e-4  # f32 round-off, see the module docstring

LM = MLAMoEConfig(hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
                  num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
                  kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=8, v_head_dim=8,
                  n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
                  max_position_embeddings=256)
GPT = GPTConfig(model_dim=64, layers=2, heads=4, max_text_tokens=64, max_mel_tokens=128,
                number_mel_codes=1026, start_mel_token=1024, stop_mel_token=1025)


def seeded(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Every floating state-dict entry N(0, 1/fan_in) (norms 1 + N(0, 0.1^2)),
    from numpy, loaded through the published keys."""
    rng = np.random.default_rng(seed)
    state = {}
    for k, v in module.state_dict().items():
        z = rng.standard_normal(tuple(v.shape)).astype(np.float32)
        if v.dim() >= 2:
            z /= np.sqrt(min(v.shape))
        else:
            z = 1.0 + 0.1 * z
        state[k] = torch.from_numpy(z)
    module.load_state_dict(state, strict=True)
    return module.eval().requires_grad_(False)


def reference_of(model: gpt_mod.UnifiedVoice) -> ref.UnifiedVoiceLM:
    r = ref.UnifiedVoiceLM(GPT, ref.Config.of(dataclasses.asdict(LM)))
    r.load_state_dict(model.state_dict(), strict=True)
    return r.eval().requires_grad_(False)


@pytest.fixture(scope="module")
def pair():
    torch.manual_seed(0)
    model = seeded(gpt_mod.UnifiedVoice(GPT, trunk=LM), 1)
    return model, reference_of(model)


def close(got, want, rtol=RTOL):
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= rtol, err


def test_published_keys(pair):
    model, _ = pair
    keys = set(model.state_dict())
    for k in ("gpt.h.0.mlp.gate_proj.weight", "gpt.h.1.mlp.gate.weight",
              "gpt.h.1.mlp.gate.e_score_correction_bias", "gpt.h.1.mlp.experts.7.down_proj.weight",
              "gpt.h.1.mlp.shared_experts.up_proj.weight", "gpt.h.0.self_attn.kv_a_proj_with_mqa.weight",
              "gpt.h.0.self_attn.kv_a_layernorm.weight", "gpt.h.1.post_attention_layernorm.weight",
              "gpt.ln_f.weight"):
        assert k in keys
    assert not any("gate_up" in k or k.endswith("experts.down") for k in keys)
    sd = model.state_dict()
    assert sd["gpt.h.1.mlp.experts.3.up_proj.weight"].shape == (32, 64)
    assert torch.equal(sd["gpt.h.1.mlp.experts.3.up_proj.weight"],
                       model.gpt.h[1].mlp.experts.gate_up[3, 32:])


def test_decode_through_cache_matches_full_forward(pair):
    """Prefill, then each served code decoded through the latent cache: the
    logits that predicted every served code, against the reference's one
    causal forward over text, prompt and codes."""
    model, r = pair
    g = torch.Generator().manual_seed(2)
    text = torch.randint(1, 200, (3, 16), generator=g)
    prompt = torch.randint(0, 1024, (3, 16), generator=g)
    served = torch.randint(0, 1024, (3, 10), generator=g)
    with torch.no_grad():
        cache, logits, prefix, mel_off = model.prefill(text, prompt, 64)
        got = [logits]
        for i in range(served.shape[1] - 1):
            got.append(model.decode_one(served[:, i], cache, prefix + i, mel_off + i))
        want = r.decode_logits(text, prompt, served)
    close(torch.stack(got, 1), want)


def test_absorbed_decode_equals_full_form(pair):
    """One MLA layer: the last row of a full-form pass over T rows, against
    T - 1 rows prefilled and the last decoded in the absorbed form, at an
    int position and at an int32 word."""
    model, _ = pair
    attn = model.gpt.h[0].self_attn
    rope = mla_moe.rope_tables(LM.max_position_embeddings, LM.qk_rope_head_dim,
                               LM.rope_theta, torch.device("cpu"))
    x = torch.randn(2, 9, 64, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        full = attn(x, rope, None, 0)[:, -1]
        for pos in (8, torch.tensor([8], dtype=torch.int32)):
            cache = torch.zeros(2, 16, 24)
            attn(x[:, :8], rope, cache, 0)
            close(attn(x[:, 8:], rope, cache, pos)[:, 0], full)


def test_moe_layer_matches_reference(pair):
    model, r = pair
    x = torch.randn(2, 7, 64, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        close(model.gpt.h[1].mlp(x), r.gpt.h[1].mlp(x))


def test_expert_plain_version_is_the_loop():
    """The grouped experts' plain version against one product of every
    expert over every row, masked to each row's own expert."""
    g = torch.Generator().manual_seed(5)
    e, d, f, n = 4, 16, 8, 11
    idx = torch.randint(0, e, (n, 1), generator=g)
    x = torch.randn(n, d, generator=g)
    gate_up, down = torch.randn(e, 2 * f, d, generator=g), torch.randn(e, d, f, generator=g)
    w = torch.rand(n, 1, generator=g)
    dest, counts, token = mla_moe.group_pairs(idx, e)
    assert counts.tolist() == torch.bincount(idx[:, 0], minlength=e).tolist()
    ws = torch.empty(n).index_copy_(0, dest, w[:, 0])
    y = moe.moe_experts(x.index_select(0, token), counts, gate_up, down, ws)
    gu = torch.einsum("nd,efd->enf", x, gate_up)
    every = torch.einsum("enf,edf->end", torch.nn.functional.silu(gu[..., :f]) * gu[..., f:],
                         down)
    want = every[idx[:, 0], torch.arange(n)] * w
    close(y.index_select(0, dest), want)


def test_route_log_and_reference_hint(pair):
    """The benchmark's route capture (hooks on the routed layers) puts the
    decode's routes at their cache rows, from an int row and from a device
    word, and keeps a pass without a cache whole; the reference given them
    takes them where they differ within the band and keeps its own beyond
    it."""
    from portbench.traffic.serve_batch_lm import RouteCapture

    model, r = pair
    log = RouteCapture(model)
    try:
        text, prompt = torch.ones(1, 16, dtype=torch.long), torch.zeros(1, 16, dtype=torch.long)
        with torch.no_grad():
            cache, _, prefix, mel_off = model.prefill(text, prompt, 64)
            model.decode_one(torch.tensor([5]), cache, prefix, mel_off)
            model.decode_one(torch.tensor([6]), cache, torch.tensor([prefix + 1]),
                             torch.tensor([mel_off + 1]))
        routes = log.decode[1]
        assert routes.shape == (1, 64, LM.num_experts_per_tok) and log.decode[0] is None
        assert routes[0, : prefix + 2].max() < LM.n_routed_experts
        # a written row holds k distinct experts (an unwritten one k zeros)
        assert all(len(set(row)) == LM.num_experts_per_tok
                   for row in routes[0, : prefix + 2].tolist())
        assert int(routes[0, prefix + 2:].abs().sum()) == 0
        with torch.no_grad():
            model(text, torch.tensor([16]), prompt, torch.tensor([16 * 1024]))
        assert log.latent[1].shape[-1] == LM.num_experts_per_tok and log.latent[0] is None
    finally:
        log.remove()
    assert not model.gpt.h[1]._forward_pre_hooks and not model.gpt.h[1].mlp.gate._forward_hooks
    gate = r.gpt.h[1].mlp.gate
    x = torch.randn(6, 64, generator=torch.Generator().manual_seed(6))
    own, _ = gate(x)
    other = own.clone()
    other[:, 0] = (own[:, 0] + 1) % LM.n_routed_experts
    tally = {}
    taken, _ = gate(x, other, band=10.0, tally=tally)
    assert set(map(tuple, taken.sort(1).values.tolist())) == set(map(tuple, other.sort(1).values
                                                                      .tolist()))
    kept, _ = gate(x, other, band=0.0, tally={})
    differ = (own.sort(1).values != other.sort(1).values).any(1)
    assert torch.equal(kept[differ], own[differ]) and tally["route_taken"] == int(differ.sum())


def tiny_ttts() -> TTTSConfig:
    return TTTSConfig(
        audio=AudioConfig(sampling_rate=32000, filter_length=1024, hop_length=640,
                          win_length=1024, n_mel_channels=32),
        acoustic_mel=AcousticMelConfig(sample_rate=24000, n_fft=256, hop_length=256,
                                       n_mels=100),
        vqvae=VQVAEConfig(inter_channels=16, hidden_channels=16, filter_channels=32,
                          n_heads=2, n_layers=2, p_dropout=0.0, upsample_initial_channel=32,
                          gin_channels=16, codebook_bins=32, posterior_wn_layers=2,
                          flow_layers=1, flow_wn_layers=1),
        gpt=GPT,
        diffusion_net=DiffusionNetConfig(in_channels=100, out_channels=200, model_channels=64,
                                         num_heads=4, num_layers=1, in_latent_channels=64),
        clvp=CLVPConfig(dim_text=32, dim_speech=32, dim_latent=16, num_text_tokens=256,
                        num_speech_tokens=1026, text_enc_depth=1, speech_enc_depth=1,
                        text_heads=2, speech_heads=2),
        vocos=VocosConfig(input_channels=100, dim=32, intermediate_dim=96, num_layers=1,
                          n_fft=1024, hop_length=256))


def test_tts_batch_with_the_trunk():
    from ttts_tpu_torch.api import TextToSpeech

    tts = TextToSpeech(tiny_ttts(), device="cpu", seed=0, trunk=LM)
    assert isinstance(tts.gpt.gpt.h[1], mla_moe.Block)
    assert all(p.dtype == torch.float32 and not p.is_meta for p in tts.gpt.parameters())
    t = np.arange(32000) / 32000
    voice = (0.3 * np.sin(2 * np.pi * 150 * t)).astype(np.float32)
    eager = gpt_mod.inference_speech.graphs["eager_steps"]
    before = moe.counters()["moe.pairs"]
    wavs = tts.tts_batch(["ni3 hao3", "jin1 tian1 hao3"], voice, 32000, "fast", 8, seed=1)
    assert len(wavs) == 2 and all(w.ndim == 1 and w.size and np.isfinite(w).all() for w in wavs)
    assert gpt_mod.inference_speech.graphs["eager_steps"] - eager == 8
    assert moe.counters()["moe.pairs"] > before


def test_materialize_makes_each_dtype_directly():
    with torch.device("meta"):
        model = gpt_mod.UnifiedVoice(GPT, trunk=LM)
    mla_moe.materialize(model, torch.device("cpu"), torch.bfloat16, 0)
    blk = model.gpt.h[1]
    assert blk.mlp.experts.gate_up.dtype == torch.bfloat16
    assert blk.self_attn.q_proj.weight.dtype == torch.bfloat16
    assert blk.mlp.gate.weight.dtype == torch.float32
    assert blk.input_layernorm.weight.dtype == torch.float32
    assert model.mel_head.weight.dtype == torch.float32 and model.act_dtype == torch.bfloat16
    assert float(blk.input_layernorm.weight.detach().min()) == 1.0


def test_mismatched_config_raises():
    with pytest.raises(ValueError, match="hidden_size"):
        gpt_mod.UnifiedVoice(dataclasses.replace(GPT, model_dim=32), trunk=LM)
    with pytest.raises(ValueError, match="num_hidden_layers"):
        gpt_mod.UnifiedVoice(dataclasses.replace(GPT, layers=3), trunk=LM)
    with pytest.raises(ValueError, match="num_attention_heads"):
        gpt_mod.UnifiedVoice(dataclasses.replace(GPT, heads=8), trunk=LM)
    with pytest.raises(NotImplementedError, match="q_lora_rank"):
        gpt_mod.UnifiedVoice(GPT, trunk=dataclasses.replace(LM, q_lora_rank=32))


def test_tensor_parallel_and_mesh_raise(pair):
    from ttts_tpu_torch.api import TextToSpeech

    model, _ = pair
    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        model.gpt.h[0](torch.zeros(1, 1, 64), tp=object())
    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        model.new_cache(1, 8, "cpu", tp=object())
    with pytest.raises(NotImplementedError, match="mesh"):
        TextToSpeech(tiny_ttts(), device="cpu", mesh=object(), trunk=LM)


def test_published_config_round_trip():
    cfg = MLAMoEConfig()
    assert MLAMoEConfig.from_published(dataclasses.asdict(cfg)) == cfg
    with pytest.raises(KeyError, match="kv_lora_rank"):
        MLAMoEConfig.from_published({k: v for k, v in dataclasses.asdict(cfg).items()
                                     if k != "kv_lora_rank"})
