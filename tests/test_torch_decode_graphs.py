"""The GPT decode as CUDA graphs on the card (marker `card`; each test skips
without a CUDA device, decided inside the `card` fixture): inference_speech
on the full-width GPT, cast for inference, through its two captured graphs
against the same step body run eagerly through the kernel and against the
loop of Python ints it replaced (the kernel taking `pos` by value): codes
equal bit for bit at 4, 64 and 256 rows on three seeds, without stops,
with some rows stopping and with every row stopping early (the loop then
ends at the next read of the stop word, every DONE_EVERY draws); a second
call of a shape replays without a capture; two text lengths inside one
CACHE_ROWS bucket share a graph; an in-place load of new weights captures
anew and gives the eager codes of the new weights; and the decode kernel
reading `pos` from a device word against the same kernel given it by value
(equal) and the plain version (within PLAIN_TOL), its caches equal, and a
word outside the caches giving NaN and leaving them untouched.
Imports torch and the port only (the card's machine has no JAX).

    python -m pytest tests/test_torch_decode_graphs.py -q   # on a card
"""

import pytest
import torch

from ttts_tpu_torch.api import cast_for_inference
from ttts_tpu_torch.config import default_config
from ttts_tpu_torch.models import gpt
from ttts_tpu_torch.models.sampling import SamplingParams, sample_logits
from ttts_tpu_torch.ops.cuda import decode_attention as dec

pytestmark = pytest.mark.card
PLAIN_TOL = 5e-3  # rel L2: bf16 caches and output against f32 arithmetic on the same values
STEPS = 40


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode graphs capture and replay only there")
    torch.manual_seed(0)
    return cast_for_inference(gpt.UnifiedVoice(default_config().gpt).eval()).cuda()


def _inputs(model, rows, seed, stops, lt=16, lp=48, steps=STEPS):
    """Text, prompt and Gumbel noise from `seed`; the stop token held down
    except at the step each row of `stops` ({row: step}) is forced to it."""
    c = model.cfg
    g = torch.Generator("cuda").manual_seed(seed)
    text = torch.randint(1, 200, (rows, lt), generator=g, device="cuda")
    prompt = torch.randint(0, 1024, (rows, lp), generator=g, device="cuda")
    u = torch.rand(steps, rows, c.number_mel_codes, generator=g, device="cuda")
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    gumbel[:, :, c.stop_mel_token] = -1e4
    for row, at in stops.items():
        gumbel[at, row, c.stop_mel_token] = 1e4
    return text, prompt, gumbel


def _stops(kind, rows, seed):
    """{row: step} of the forced stops: none, every fourth row, or every row
    (before step 30 of STEPS)."""
    g = torch.Generator().manual_seed(seed)
    at = torch.randint(1, 30, (rows,), generator=g).tolist()
    return {"none": {}, "some": {r: at[r] for r in range(0, rows, 4)},
            "all": dict(enumerate(at))}[kind]


def _eager(model, text, prompt, sampling, gumbel):
    """The step body run eagerly through the kernel as inference_speech's
    eager loop runs it (the model's step given its rows as ints), `done`
    read after every draw."""
    c, steps = model.cfg, gumbel.shape[0]
    prefix = text.shape[1] + 2 + prompt.shape[1] + 1
    cache_len = -(-(prefix + steps) // gpt.CACHE_ROWS) * gpt.CACHE_ROWS
    loop = gpt._DecodeLoop(model, text.shape[0], cache_len, steps, text.device)
    loop.start(model, text, prompt, gumbel)
    for i in range(steps):
        loop.sample(sampling, c.stop_mel_token)
        if loop.all_done():
            break
        loop.decode(model, dec.decode_attention, None, i)
    return loop.tokens.clone()


def _ints(model, text, prompt, sampling, gumbel):
    """The loop of Python ints that the step body replaced, the kernel given
    `pos` by value."""
    c, steps, b = model.cfg, gumbel.shape[0], text.shape[0]
    prefix = text.shape[1] + 2 + prompt.shape[1] + 1
    cache, logits, _, mel_off = model.prefill(text, prompt, prefix + steps)
    counts = torch.zeros(b, c.number_mel_codes, dtype=torch.int32, device="cuda")
    counts.scatter_add_(1, prompt, torch.ones_like(prompt, dtype=torch.int32))
    tokens = torch.full((b, steps), c.stop_mel_token, dtype=torch.long, device="cuda")
    done = torch.zeros(b, dtype=torch.bool, device="cuda")
    rows = torch.arange(b, device="cuda")
    for i in range(steps):
        tok = sample_logits(logits, counts, sampling, gumbel[i])
        tok = torch.where(done, c.stop_mel_token, tok)
        done = done | (tok == c.stop_mel_token)
        counts[rows, tok] += 1
        tokens[:, i] = tok
        if bool(done.all()):
            break
        logits = model.decode_one(tok, cache, prefix + i, mel_off + i, dec.decode_attention)
    return tokens


def _sampling(stops):
    # top_p 1 keeps a forced stop drawable; the nucleus filter runs without stops
    return SamplingParams(top_p=1.0 if stops else 0.8, temperature=0.8, repetition_penalty=2.0)


@pytest.mark.parametrize("kind", ["none", "some", "all"])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("rows", [4, 64, 256])
def test_graph_codes_equal_eager(card, rows, seed, kind):
    model = card
    stops = _stops(kind, rows, seed)
    text, prompt, gumbel = _inputs(model, rows, seed, stops)
    sampling = _sampling(stops)
    count, launched = dict(gpt.inference_speech.graphs), dec.decode_attention.launches
    with torch.no_grad():
        got = gpt.inference_speech(model, text, prompt, STEPS, sampling, gumbel)
        after, now = dict(gpt.inference_speech.graphs), dec.decode_attention.launches
        eager = _eager(model, text, prompt, sampling, gumbel)
        ints = _ints(model, text, prompt, sampling, gumbel)
    assert torch.equal(got, eager) and torch.equal(got, ints)
    for row, at in stops.items():
        assert int((got[row] == model.cfg.stop_mel_token).nonzero()[0, 0]) == at
    # every row stopped: the loop ends at the first read of the stop word after the last stop
    last = max(stops.values()) + 1 if kind == "all" else STEPS
    replayed = min(STEPS, -(-last // gpt.DONE_EVERY) * gpt.DONE_EVERY)
    assert after["replayed_steps"] - count["replayed_steps"] == replayed
    assert after["eager_steps"] == count["eager_steps"]
    captured = after["captures"] - count["captures"]
    decodes = replayed - (replayed < STEPS)  # the loop breaks before the last draw's decode
    assert now - launched == model.cfg.layers * (decodes + captured)  # warm-up: one step


def test_second_call_replays(card):
    model = card
    stops = _stops("some", 8, 5)
    sampling = _sampling(stops)
    text, prompt, gumbel = _inputs(model, 8, 5, stops)
    with torch.no_grad():
        first = gpt.inference_speech(model, text, prompt, STEPS, sampling, gumbel)
        count = dict(gpt.inference_speech.graphs)
        text, prompt, gumbel = _inputs(model, 8, 6, stops)
        second = gpt.inference_speech(model, text, prompt, STEPS, sampling, gumbel)
        eager = _eager(model, text, prompt, sampling, gumbel)
    assert gpt.inference_speech.graphs["captures"] == count["captures"]
    assert gpt.inference_speech.graphs["replayed_steps"] == count["replayed_steps"] + STEPS
    assert torch.equal(second, eager) and not torch.equal(first, second)


def test_text_lengths_in_one_bucket_share_a_graph(card):
    model = card
    sampling = _sampling({})
    short, long_ = _inputs(model, 16, 7, {}, lt=16), _inputs(model, 16, 8, {}, lt=32)
    rows_of = [t.shape[1] + 2 + p.shape[1] + 1 + STEPS for t, p, _ in (short, long_)]
    assert len({-(-r // gpt.CACHE_ROWS) for r in rows_of}) == 1  # one bucket
    with torch.no_grad():
        gpt.inference_speech(model, *short[:2], STEPS, sampling, short[2])
        count = dict(gpt.inference_speech.graphs)
        got = gpt.inference_speech(model, *long_[:2], STEPS, sampling, long_[2])
        eager = _eager(model, *long_[:2], sampling, long_[2])
    assert gpt.inference_speech.graphs["captures"] == count["captures"]
    assert torch.equal(got, eager)


def test_weight_load_captures_anew(card):
    """A load of new weights in place (as TextToSpeech.set_params loads a
    stage) changes the weights' versions, not their storage: the decode
    captures anew and draws the new weights' codes."""
    torch.manual_seed(1)
    model = cast_for_inference(gpt.UnifiedVoice(default_config().gpt).eval()).cuda()
    sampling = _sampling({})
    text, prompt, gumbel = _inputs(model, 4, 9, {})
    g = torch.Generator().manual_seed(3)
    state = {k: v + 0.05 * torch.randn(v.shape, generator=g).to(v.device, v.dtype)
             for k, v in model.state_dict().items()}
    with torch.no_grad():
        old = gpt.inference_speech(model, text, prompt, STEPS, sampling, gumbel)
        old_graphs = model.decode_graph[1]
        ptrs = [p.data_ptr() for p in model.parameters()]
        count = dict(gpt.inference_speech.graphs)
        model.load_state_dict(state)
        assert ptrs == [p.data_ptr() for p in model.parameters()]  # the same storage
        new = gpt.inference_speech(model, text, prompt, STEPS, sampling, gumbel)
        eager = _eager(model, text, prompt, sampling, gumbel)
    assert gpt.inference_speech.graphs["captures"] == count["captures"] + 1
    assert model.decode_graph[1] is not old_graphs  # the old weights' graphs are gone
    assert torch.equal(new, eager) and not torch.equal(new, old)


def _rel(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


@pytest.mark.parametrize("b", [1, 4])
def test_word_kernel_matches_value_kernel_and_plain(card, b):
    """chip_smoke's positions: the boundaries of the 8 cluster ranks' shares
    of rows [0, pos], the middle and the end of a 563-row cache."""
    g = torch.Generator("cuda").manual_seed(4)
    h, dk, ml = 8, 64, 563
    kc = torch.randn(b, h, ml, dk, generator=g, device="cuda").to(torch.bfloat16)
    vc = torch.randn(b, h, ml, dk, generator=g, device="cuda").to(torch.bfloat16)
    for pos in (0, 1, 7, 8, 63, 64, 281, ml - 1):
        q, uk, uv = (torch.randn(b, h, dk, generator=g, device="cuda").to(torch.bfloat16)
                     for _ in range(3))
        k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        word = torch.tensor([pos], dtype=torch.int32, device="cuda")
        got = dec.decode_attention(q, uk, uv, k1, v1, word)
        by_value = dec.decode_attention(q, uk, uv, k2, v2, pos)
        assert torch.equal(got, by_value) and torch.equal(k1, k2) and torch.equal(v1, v2)
        k3, v3 = kc.clone(), vc.clone()
        want = dec.decode_attention_plain(q.float(), uk.float(), uv.float(), k3.float(),
                                          v3.float(), pos)
        assert _rel(got, want) <= PLAIN_TOL, pos
        assert torch.equal(k1[:, :, pos], uk) and torch.equal(v1[:, :, pos], uv)
    for pos in (-1, ml):  # the kernel's own guard: NaN out, caches untouched
        k1, v1 = kc.clone(), vc.clone()
        word = torch.tensor([pos], dtype=torch.int32, device="cuda")
        out = dec.decode_attention(q, uk, uv, k1, v1, word)
        torch.cuda.synchronize()
        assert bool(out.isnan().all()) and torch.equal(k1, kc) and torch.equal(v1, vc)
    with pytest.raises(ValueError):
        dec.decode_attention(q, uk, uv, kc.clone(), vc.clone(), ml)  # by value: the host check
