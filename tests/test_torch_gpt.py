"""PyTorch port parity: UnifiedVoice prefill / decode / latent, the sampling
warpers, the decode-attention plain version and the generation loop
(ttts_tpu_torch against ttts_tpu) on the CPU, in f32.

Tolerances: logits and latents within 1e-4 (f32, summation order only);
warper keep-masks equal; tokens identical when the port is fed JAX's own
Gumbel draws (jax.random.categorical is argmax(logits + gumbel))."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from test_api import TINY
from test_torch_config import to_port
from ttts_tpu.models import gpt as jgpt
from ttts_tpu.models import porting as jporting
from ttts_tpu.models import sampling as jsamp
from ttts_tpu.ops.pallas import decode_attention as jdec
from ttts_tpu_torch import porting
from ttts_tpu_torch.models import sampling as tsamp
from ttts_tpu_torch.models.gpt import UnifiedVoice, inference_speech
from ttts_tpu_torch.ops.cuda import decode_attention as dec
from ttts_tpu_torch.ops.cuda.decode_attention import decode_attention

ATOL = 1e-4
C = TINY.gpt


@pytest.fixture(scope="module")
def gpt():
    model = jgpt.UnifiedVoice(C)
    variables = jax.jit(model.init)(jax.random.key(0), jnp.zeros((1, 8), jnp.int32),
                                    jnp.asarray([8]), jnp.zeros((1, 16), jnp.int32),
                                    jnp.asarray([16 * 1024]))
    port = UnifiedVoice(to_port(C)).eval()
    port.load_state_dict({k: torch.from_numpy(v) for k, v in
                          porting.unified_voice_state_dict(variables).items()})
    return model, variables, port


def _inputs(seed=0, b=2, lt=16, lp=16):
    rng = np.random.default_rng(seed)
    text = rng.integers(1, 200, (b, lt)).astype(np.int32)
    prompt = rng.integers(0, 1024, (b, lp)).astype(np.int32)
    return text, prompt


def test_prefill_and_teacher_forced_decode_logits(gpt):
    model, variables, port = gpt
    text, prompt = _inputs()
    prefix = text.shape[1] + 2 + prompt.shape[1] + 1
    max_len = prefix + 8
    cache, logits, p, mel_off = model.apply(variables, jnp.asarray(text), jnp.asarray(prompt),
                                            max_len, method=model.prefill)
    with torch.no_grad():
        tcache, tlogits, tp, tmel = port.prefill(torch.from_numpy(text).long(),
                                                 torch.from_numpy(prompt).long(), max_len)
        assert (tp, tmel) == (p, mel_off) == (prefix, prompt.shape[1] + 1)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(logits), atol=ATOL, rtol=0)
        toks = np.random.default_rng(1).integers(0, 1024, (6, text.shape[0]))
        for i, tok in enumerate(toks):
            logits, cache = model.apply(variables, jnp.asarray(tok, jnp.int32), cache,
                                        prefix + i, mel_off + i, max_len,
                                        method=model.decode_one)
            tlogits = port.decode_one(torch.from_numpy(tok).long(), tcache, prefix + i,
                                      mel_off + i)
            np.testing.assert_allclose(tlogits.numpy(), np.asarray(logits), atol=ATOL,
                                       rtol=0, err_msg=f"step {i}")


def test_return_latent(gpt):
    model, variables, port = gpt
    text, _ = _inputs(2)
    codes = np.random.default_rng(3).integers(0, 1024, (2, 24)).astype(np.int32)
    wav_len = np.asarray([20 * 1024, 13 * 1024])
    want = model.apply(variables, jnp.asarray(text), jnp.asarray([16, 16]),
                       jnp.asarray(codes), jnp.asarray(wav_len), return_latent=True)
    with torch.no_grad():
        got = port(torch.from_numpy(text).long(), torch.tensor([16, 16]),
                   torch.from_numpy(codes).long(), torch.from_numpy(wav_len),
                   return_latent=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.fixture
def interpret_decode(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(jdec.pl, "pallas_call",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    jdec.fused_decode_attention.clear_cache()
    yield
    jdec.fused_decode_attention.clear_cache()


def _unpack(x, h, b):
    """packed (..., dk, H*B) head-major → (B, H, ..., dk)."""
    lead = x.shape[:-2]
    y = x.reshape(*lead, x.shape[-2], h, b)
    return np.moveaxis(np.moveaxis(y, -1, 0), -1, 1).copy()


# the kernel's 8 cluster ranks take ceil((pos+1)/8) rows each: 0, 1, 7, 8,
# 63, 64, 281 and 562 sit on the boundaries of those shares
@pytest.mark.parametrize("pos", [0, 1, 7, 8, 63, 64, 200, 255, 281, 562])
def test_decode_attention_plain_matches_reference_and_kernel(interpret_decode, pos):
    rng = np.random.default_rng(pos)
    ml, dk, h, b = 256 if pos < 256 else 576, 16, 8, 16
    q, uk, uv = (rng.standard_normal(s).astype(np.float32)
                 for s in ((dk, h * b), (1, dk, h * b), (1, dk, h * b)))
    kc, vc = (rng.standard_normal((ml, dk, h * b)).astype(np.float32) for _ in range(2))
    ref, kr, vr = jdec.decode_attention_reference(*map(jnp.asarray, (q, uk, uv, kc, vc)), pos)
    ker, _, _ = jdec.fused_decode_attention(*map(jnp.asarray, (q, uk, uv, kc, vc)), pos,
                                            blk=64)
    tk, tv = torch.from_numpy(_unpack(kc, h, b)), torch.from_numpy(_unpack(vc, h, b))
    got = decode_attention(torch.from_numpy(_unpack(q, h, b)),
                           torch.from_numpy(_unpack(uk[0], h, b)),
                           torch.from_numpy(_unpack(uv[0], h, b)), tk, tv, pos)
    np.testing.assert_allclose(got.numpy(), _unpack(np.asarray(ref), h, b), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), _unpack(np.asarray(ker), h, b), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tk.numpy(), _unpack(np.asarray(kr), h, b))
    np.testing.assert_array_equal(tv.numpy(), _unpack(np.asarray(vr), h, b))


def _typical_rows(logits, counts):
    """Rows 0 and 1 of the typical cases, set after the penalty (counts 0)
    and the temperature: a uniform row (every surprisal ties: the stable
    sort keeps vocabulary order), and probabilities 0.5 (token 2), 0.2
    (tokens 5 and 9) and 0.1 spread over the rest, whose entropy (1.91)
    makes the tied 0.2 tokens the most typical: at mass 0.3 the boundary
    falls between them and the lower index is kept."""
    logits[0] = 0.0
    row = np.full(logits.shape[1], np.log(0.1 / (logits.shape[1] - 3)))
    row[[2, 5, 9]] = np.log([0.5, 0.2, 0.2])
    logits[1] = (row * 0.8).astype(np.float32)
    counts[:2] = 0


@pytest.mark.parametrize("top_k,top_p,typical_mass", [
    (0, 0.8, None), (50, 0.9, None), (0, 1.0, None),
    (0, 1.0, 0.9), (0, 1.0, 0.3), (50, 0.8, 0.9), (0, 0.8, 0.3)])
def test_warper_keep_masks_equal(top_k, top_p, typical_mass):
    """The warpers in JAX's order (repetition → temperature → typical →
    top-k → top-p), keep masks bit-equal; with typical sampling also a
    uniform row and a tie at the mass boundary (_typical_rows)."""
    rng = np.random.default_rng(top_k)
    logits = (rng.standard_normal((4, 1026)) * 3).astype(np.float32)
    logits[:, 7] = logits[:, 9]  # a tie at whatever rank it lands
    counts = rng.integers(0, 2, (4, 1026)).astype(np.int32)
    typical = typical_mass is not None
    if typical:
        _typical_rows(logits, counts)
    params = dict(temperature=0.8, top_p=top_p, top_k=top_k, repetition_penalty=2.0,
                  typical_sampling=typical, typical_mass=typical_mass or 0.9)
    jl = jnp.asarray(logits)
    jl = jsamp.apply_repetition_penalty(jl, jnp.asarray(counts), 2.0) / 0.8
    if typical:
        jl = jsamp.apply_typical(jl, typical_mass)
    want = np.asarray(jsamp.apply_top_p(jsamp.apply_top_k(jl, top_k), top_p))
    got = tsamp.warp_logits(torch.from_numpy(logits), torch.from_numpy(counts),
                            tsamp.SamplingParams(**params)).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    keep = np.isfinite(want)
    np.testing.assert_allclose(got[keep], want[keep], atol=1e-6, rtol=0)
    if typical and top_k == 0 and top_p == 1.0:
        assert keep[0].sum() == int(np.ceil(typical_mass * 1026)) - 1  # a prefix ...
        assert keep[0, : keep[0].sum()].all()  # ... in vocabulary order
        if typical_mass == 0.8:
            assert sorted(np.flatnonzero(keep[1])) == [2, 5]


@pytest.mark.parametrize("typical", [False, True])
def test_generation_with_jax_draws_is_identical(gpt, typical):
    model, variables, port = gpt
    text, prompt = _inputs(5, b=2)
    max_gen = 24
    sampling = jsamp.SamplingParams(top_p=0.8, temperature=0.8, repetition_penalty=2.0,
                                    typical_sampling=typical)
    key = jax.random.key(11)
    want = np.asarray(jgpt.inference_speech(model, variables, jnp.asarray(text),
                                            jnp.asarray(prompt), key, max_gen, sampling))
    gumbel = np.stack([np.asarray(jax.random.gumbel(k, (2, C.number_mel_codes)))
                       for k in jax.random.split(key, max_gen)])
    with torch.no_grad():
        got = inference_speech(port, torch.from_numpy(text).long(),
                               torch.from_numpy(prompt).long(), max_gen,
                               tsamp.SamplingParams(top_p=0.8, temperature=0.8,
                                                    repetition_penalty=2.0,
                                                    typical_sampling=typical),
                               torch.from_numpy(gumbel))
    assert (want[:, :4] != C.stop_mel_token).all()  # real draws, not an instant stop
    np.testing.assert_array_equal(got.numpy(), want)


def _loop_of_ints(model, text, prompt, max_gen, sampling, gumbel):
    """The generation loop as it was before its step became one body over
    buffers and device words (positions as Python ints, `done` read after
    every draw), frozen here as the step body's reference. Returns the
    codes and the number of draws."""
    c = model.cfg
    b = text.shape[0]
    prefix_len = text.shape[1] + 2 + prompt.shape[1] + 1
    cache, logits, _, mel_off = model.prefill(text, prompt, prefix_len + max_gen)
    counts = torch.zeros(b, c.number_mel_codes, dtype=torch.int32)
    counts.scatter_add_(1, prompt, torch.ones_like(prompt, dtype=torch.int32))
    tokens = torch.full((b, max_gen), c.stop_mel_token, dtype=torch.long)
    done = torch.zeros(b, dtype=torch.bool)
    rows = torch.arange(b)
    step = dec.pick(model.act_dtype, c.model_dim // c.heads)
    for i in range(max_gen):
        tok = tsamp.sample_logits(logits, counts, sampling, gumbel[i])
        tok = torch.where(done, c.stop_mel_token, tok)
        done = done | (tok == c.stop_mel_token)
        counts[rows, tok] += 1
        tokens[:, i] = tok
        if bool(done.all()):
            break
        logits = model.decode_one(tok, cache, prefix_len + i, mel_off + i, step)
    return tokens, i + 1


# (draws, {row: the step at which its stop is forced}, top_p): no stop; rows
# stopping apart, one 3 steps before a multiple of 8, one never; every row
# stopping (the loop ends early); a length that is no multiple of 8
STOPS = {"no_stop": (24, {}, 0.8), "rows_apart": (24, {0: 4, 1: 13}, 1.0),
         "all_stop": (24, {0: 2, 1: 13, 2: 7}, 1.0), "ragged_length": (19, {2: 10}, 1.0)}


@pytest.mark.parametrize("case", sorted(STOPS))
def test_step_body_matches_the_loop_of_ints(gpt, case):
    """inference_speech's step body (buffers, the noise's row and the
    tokens' column from a device word) draws the codes of the loop it
    replaced, on the CPU's eager loop; the
    stops are forced through the noise (top_p 1 keeps the stop token
    drawable)."""
    _, _, port = gpt
    max_gen, stops, top_p = STOPS[case]
    text, prompt = (torch.from_numpy(a).long() for a in _inputs(3, b=3))
    rng = np.random.default_rng(7)
    gumbel = torch.from_numpy(rng.gumbel(size=(max_gen, 3, C.number_mel_codes))
                              .astype(np.float32))
    gumbel[:, :, C.stop_mel_token] = -1e4
    for row, at in stops.items():
        gumbel[at, row, C.stop_mel_token] = 1e4
    sampling = tsamp.SamplingParams(top_p=top_p, temperature=0.8, repetition_penalty=2.0)
    before = dict(inference_speech.graphs)
    with torch.no_grad():
        want, draws = _loop_of_ints(port, text, prompt, max_gen, sampling, gumbel)
        got = inference_speech(port, text, prompt, max_gen, sampling, gumbel)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    for row in range(3):  # each row stops where forced, and only there
        first = np.flatnonzero(got[row].numpy() == C.stop_mel_token)
        assert (first[0] if len(first) else None) == stops.get(row)
    assert draws == (max(stops.values()) + 1 if len(stops) == 3 else max_gen)
    after = inference_speech.graphs
    assert after["eager_steps"] - before["eager_steps"] == draws
    assert (after["captures"], after["replayed_steps"]) == (before["captures"],
                                                            before["replayed_steps"])


def test_eager_step_gives_the_decode_int_rows(gpt, monkeypatch):
    """The eager loop gives the decode its cache rows as ints, one per layer
    a step: the plain decode slices its rows on the host, where a device
    word would cost a synchronise on the card."""
    _, _, port = gpt
    seen, plain = [], dec.decode_attention_plain

    def recorded(q, uk, uv, k_cache, v_cache, pos):
        seen.append(pos)
        return plain(q, uk, uv, k_cache, v_cache, pos)

    monkeypatch.setattr(dec, "decode_attention_plain", recorded)
    text, prompt = (torch.from_numpy(a).long() for a in _inputs(5, b=2))
    gumbel = torch.zeros(5, 2, C.number_mel_codes)
    gumbel[:, :, C.stop_mel_token] = -1e4
    sampling = tsamp.SamplingParams(top_p=0.8, temperature=0.8, repetition_penalty=2.0)
    with torch.no_grad():
        inference_speech(port, text, prompt, 5, sampling, gumbel)
    prefix = text.shape[1] + 2 + prompt.shape[1] + 1
    assert seen == [prefix + i for i in range(5) for _ in range(C.layers)]
    assert all(type(pos) is int for pos in seen)


def test_converter_round_trip(gpt):
    _, variables, port = gpt
    sd = porting.unified_voice_state_dict(variables)
    assert set(sd) == set(port.state_dict())
    back = jporting.port_unified_voice_state(sd, C.layers)
    want = jax.tree_util.tree_map(np.asarray, variables["params"])
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, want)
