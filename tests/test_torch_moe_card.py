"""The grouped expert kernel (csrc/moe_experts.cu through ops/cuda/moe.py)
and the MLA-MoE trunk's decode graphs on the card (marker `card`; each test
skips without a CUDA device, decided inside the `dev` fixture): the kernel
against its plain version at the published widths (D 2048, F 1408, 64
experts, top 6) at a decode batch (64 rows), at a few rows (most experts
without pairs) and at a prefill-sized batch; its pairs / experts-read
counter; one captured launch replayed over three routings; and a small
trunk's decode through its two CUDA graphs against the same step body run
eagerly (codes equal bit for bit). Imports torch and the port only.

    python -m pytest tests/test_torch_moe_card.py -q   # on a card
"""

import pytest
import torch

from ttts_tpu_torch.config import GPTConfig, MLAMoEConfig
from ttts_tpu_torch.models import gpt, mla_moe
from ttts_tpu_torch.models.sampling import SamplingParams
from ttts_tpu_torch.ops.cuda import moe

pytestmark = pytest.mark.card
# rel L2: bf16 inputs and h, f32 sums in another order; h rounds to bf16 on
# both sides, and a last-bit difference there moves y by ~2^-9 of that term
PLAIN_TOL = 5e-3
E, D, F, K = 64, 2048, 1408, 6


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the expert kernel runs only there")
    return torch.device("cuda", 0)


def experts(dev, e=E, d=D, f=F, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    gate_up = (torch.randn(e, 2 * f, d, generator=g, device=dev) / d ** 0.5).bfloat16()
    down = (torch.randn(e, d, f, generator=g, device=dev) / f ** 0.5).bfloat16()
    return gate_up, down


def routed(dev, rows, seed, e=E, d=D, k=K):
    """Rows, their k distinct experts from random scores, weights: the
    kernel's inputs (xs, counts, ws) and the pair order (dest)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(rows, d, generator=g, device=dev).bfloat16()
    idx = torch.rand(rows, e, generator=g, device=dev).topk(k, dim=-1).indices
    w = torch.rand(rows, k, generator=g, device=dev)
    dest, counts, token = mla_moe.group_pairs(idx, e)
    ws = torch.empty(rows * k, device=dev).index_copy_(0, dest, w.reshape(-1))
    return x.index_select(0, token), counts, ws


def rel(got, want):
    return float((got - want).norm() / want.norm())


@pytest.mark.parametrize("rows", [64, 2, 1600])
def test_kernel_matches_plain(dev, rows):
    gate_up, down = experts(dev)
    xs, counts, ws = routed(dev, rows, rows)
    y = moe.moe_experts(xs, counts, gate_up, down, ws)
    torch.cuda.synchronize()
    assert rel(y, moe.moe_experts_plain(xs, counts, gate_up, down, ws)) < PLAIN_TOL


def test_counter_counts_pairs_and_experts_read(dev):
    gate_up, down = experts(dev)
    xs, counts, ws = routed(dev, 3, 7)
    moe.moe_experts(xs, counts, gate_up, down, ws)  # makes the counter of 18 pairs
    stats = moe.moe_experts.stats[(str(dev), 18)]
    before = stats.clone()
    launches = moe.moe_experts.launches
    moe.moe_experts(xs, counts, gate_up, down, ws)
    assert (stats - before).tolist() == [18, int((counts > 0).sum())]
    assert moe.moe_experts.launches == launches + 1


def test_one_graph_serves_every_routing(dev):
    gate_up, down = experts(dev)
    xs, counts, ws = routed(dev, 64, 1)
    moe.moe_experts(xs, counts, gate_up, down, ws)  # warm-up: the counter of its shape
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = moe.moe_experts(xs, counts, gate_up, down, ws)
    for seed in (2, 3, 4):
        new = routed(dev, 64, seed)
        for buf, src in zip((xs, counts, ws), new):
            buf.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        assert rel(y, moe.moe_experts_plain(*new[:2], gate_up, down, new[2])) < PLAIN_TOL


def test_trunk_decode_graphs_equal_eager(dev):
    """A 3-layer trunk of kernel-sized widths, bf16: the decode through its
    two captured graphs against the step body run eagerly with int
    positions, the same kernels either way."""
    lm = MLAMoEConfig(hidden_size=256, intermediate_size=512, moe_intermediate_size=128,
                      num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4,
                      kv_lora_rank=64, qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
                      n_routed_experts=16, num_experts_per_tok=4, n_shared_experts=1,
                      max_position_embeddings=1024)
    cfg = GPTConfig(model_dim=256, layers=3, heads=4)
    with torch.device("meta"):
        model = gpt.UnifiedVoice(cfg, trunk=lm)
    mla_moe.materialize(model, dev, torch.bfloat16, 0).eval().requires_grad_(False)
    g = torch.Generator(device=dev).manual_seed(5)
    rows, steps = 8, 24
    text = torch.randint(1, 255, (rows, 16), generator=g, device=dev)
    prompt = torch.randint(0, 1024, (rows, 16), generator=g, device=dev)
    gumbel = -torch.log(-torch.log(torch.rand(steps, rows, 1026, generator=g, device=dev)))
    sampling = SamplingParams(top_p=0.8, temperature=0.8, repetition_penalty=2.0)
    with torch.no_grad():
        captures = gpt.inference_speech.graphs["captures"]
        graphed = gpt.inference_speech(model, text, prompt, steps, sampling, gumbel)
        assert gpt.inference_speech.graphs["captures"] == captures + 1
        prefix = text.shape[1] + 2 + prompt.shape[1] + 1
        cache_len = -(-(prefix + steps) // gpt.CACHE_ROWS) * gpt.CACHE_ROWS
        loop = gpt._DecodeLoop(model, rows, cache_len, steps, dev)
        loop.start(model, text, prompt, gumbel)
        for i in range(steps):
            loop.sample(sampling, cfg.stop_mel_token)
            loop.decode(model, None, None, i)
    assert torch.equal(graphed, loop.tokens)
