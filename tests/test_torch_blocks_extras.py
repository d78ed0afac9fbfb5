"""PyTorch port parity of the rest of the model library's building blocks
on the CPU, in f32: the windowed attention's proximal bias, causal mask,
cross-attention and qk_scale; TransformerDecoder; MelStyleEncoderVAE;
LayerNorm1d, Snake and mish; GroupQuantizer; the Tortoise-v1 tacotron mel
and its min-max normalisation; DiffusionTts's training forward. Each
against the ttts_tpu module on the same numpy inputs, weights carried by
ttts_tpu_torch.porting (seeded fills of JAX's variable shapes).

Tolerances (relative L2 unless named), each from the largest of three
readings (seed offsets 0-2): TOL 1e-5 for activations, read 3.5e-7;
MEL_TOL 1e-5 on the log mel, read 2.4e-7; GroupQuantizer codes
bit-identical, its outputs and gradients read 0 apart. DiffusionTts's
training forward, with JAX's draws (the unconditioned rows, the per-layer
keeps) injected through jax.random.uniform / bernoulli: 9.3e-7 without an
unconditioned row; with one, 6.4e-6, 2.1e-5 and 4.4e-4, so DT_TOL is
BASELINE's 1e-3. There JAX's f32 is the side that strays: the
unconditioned row's code embedding is constant in time, and flax's
GroupNorm takes the variance as E[x^2] - E[x]^2 (read 6.3e-4 off the
port's f64 forward, where the port's f32 reads 1.0e-6), so the port's f32
is also held to its own f64 forward within TOL."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_codec_synth import rel, seeded_variables
from ttts_tpu.models import blocks as jblocks
from ttts_tpu.models.diffusion_tts_v1 import DiffusionTts as JDiffusionTts
from ttts_tpu.models.group_quantizer import GroupQuantizer as JGroupQuantizer
from ttts_tpu.ops import mel as jmel
from ttts_tpu_torch import porting
from ttts_tpu_torch.models import blocks
from ttts_tpu_torch.models.diffusion_tts_v1 import DiffusionTts
from ttts_tpu_torch.models.group_quantizer import GroupQuantizer
from ttts_tpu_torch.ops import mel

TOL = MEL_TOL = GRAD_TOL = 1e-5
DT_TOL = 1e-3


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _mask(lengths, t):
    return (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)[..., None]


def _load(port, sd):
    assert set(sd) == set(port.state_dict()), set(sd) ^ set(port.state_dict())
    port.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return port.eval()


@pytest.mark.parametrize("case", ["proximal_causal", "cross_scaled", "window_proximal"])
def test_attention_extension(case):
    """blocks.MultiHeadAttention against ttts_tpu's RelPosMultiHeadAttention
    with proximal_bias and a causal mask, a cross-attention with qk_scale,
    and the window with the proximal bias."""
    c, h, t = 16, 2, 7
    kw = {"proximal_causal": dict(proximal_bias=True),
          "cross_scaled": dict(qk_scale=0.3),
          "window_proximal": dict(proximal_bias=True, window_size=4)}[case]
    x = _rand(0, 2, t, c)
    src = _rand(1, 2, 9 if case == "cross_scaled" else t, c)
    if case == "proximal_causal":
        mask = np.tril(np.ones((t, t), np.float32))[None, None]
    else:
        mask = _mask([t, 5], t)[:, None, :, 0][..., None] * _mask([src.shape[1], 6],
                                                                    src.shape[1])[:, None, :, 0][:, :, None]
    model = jblocks.RelPosMultiHeadAttention(c, c, h, **kw)
    variables = seeded_variables(lambda: model.init(jax.random.key(0), x, src, mask))
    sd = {}
    porting._vits_mha(sd, "m", variables["params"])
    port = _load(blocks.MultiHeadAttention(c, c, h, **kw), {k[2:]: v for k, v in sd.items()})
    want = model.apply(variables, x, src, mask)
    with torch.no_grad():
        got = port(*_t(x, src, mask))
    assert rel(got, want) <= TOL


@pytest.fixture(scope="module")
def decoder():
    model = jblocks.TransformerDecoder(16, 32, 2, 2, kernel_size=3)
    x, h = _rand(2, 2, 6, 16), _rand(3, 2, 9, 16)
    xm, hm = _mask([6, 4], 6), _mask([9, 6], 9)
    variables = seeded_variables(lambda: model.init(jax.random.key(0), x, xm, h, hm))
    port = _load(blocks.TransformerDecoder(16, 32, 2, 2, kernel_size=3),
                 porting.transformer_decoder_state_dict(variables))
    return model, variables, port, (x, xm, h, hm)


def test_transformer_decoder(decoder):
    """tests/test_decoder_block.py's shapes: parity, causality (a change of
    the last frame leaves the others) and the converter's inverse."""
    model, variables, port, (x, xm, h, hm) = decoder
    want = model.apply(variables, x, xm, h, hm)
    x2 = x.copy()
    x2[:, -1] += 10.0
    with torch.no_grad():
        got = port(*_t(x, xm, h, hm))
        got2 = port(*_t(x2, xm, h, hm))
    assert got.shape == want.shape and rel(got, want) <= TOL
    torch.testing.assert_close(got[:, :-1], got2[:, :-1], atol=1e-6, rtol=0)
    back = porting.transformer_decoder_variables(port.state_dict())
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("train", [False, True])
def test_mel_style_encoder_vae(train, monkeypatch):
    """tests/test_parity_extras.py's sizes, dropout 0 on both sides (JAX's
    fixed 0.1 patched), the reparameterisation noise injected."""
    monkeypatch.setattr(jblocks, "MelStyleEncoder",
                        functools.partial(jblocks.MelStyleEncoder, p_dropout=0.0))
    model = jblocks.MelStyleEncoderVAE(spec_channels=16, z_latent_dim=8, emb_dim=32)
    x, mask = _rand(4, 2, 10, 16), _mask([10, 7], 10)
    variables = seeded_variables(lambda: model.init(
        {"params": jax.random.key(0), "noise": jax.random.key(1)}, x, mask))
    noise = _rand(5, 2, 8)
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, *a, **k: jnp.asarray(noise))
    want, want_kl = model.apply(variables, x, mask, train=train, rngs={"noise": jax.random.key(3)})
    port = _load(blocks.MelStyleEncoderVAE(16, 8, 32),
                 porting.mel_style_encoder_vae_state_dict(variables))
    for m in port.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    port.train(train)
    with torch.no_grad():
        got, kl = port(*_t(x, mask), noise=torch.from_numpy(noise))
    assert got.shape == (2, 32) and rel(got, want) <= TOL
    assert abs(kl.item() - float(want_kl)) <= TOL * abs(float(want_kl))
    with torch.no_grad():
        np.testing.assert_allclose(port.infer(torch.from_numpy(noise)).numpy(),
                                   model.apply(variables, noise, method=model.infer),
                                   rtol=TOL, atol=TOL)
    back = porting.mel_style_encoder_vae_variables(port.state_dict())
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, variables))


@pytest.mark.parametrize("logscale", [False, True])
def test_layernorm1d_snake_mish(logscale):
    x = _rand(6, 2, 5, 8) * 2
    ln = jblocks.LayerNorm1d()
    lv = seeded_variables(lambda: ln.init(jax.random.key(0), x))
    sd = {}
    porting._layernorm(sd, "m", lv["params"]["LayerNorm_0"])
    port_ln = _load(blocks.LayerNorm1d(8), {k[2:]: v for k, v in sd.items()})
    snake = jblocks.Snake(8, alpha_logscale=logscale)
    sv = seeded_variables(lambda: snake.init(jax.random.key(0), x))
    port_snake = blocks.Snake(8, alpha_logscale=logscale)
    port_snake.load_state_dict({"alpha": torch.from_numpy(np.asarray(sv["params"]["alpha"]))})
    with torch.no_grad():
        for got, want in ((port_ln(torch.from_numpy(x)), ln.apply(lv, x)),
                          (port_snake(torch.from_numpy(x)), snake.apply(sv, x)),
                          (blocks.mish(torch.from_numpy(x)), jblocks.mish(x))):
            assert rel(got, want) <= TOL


@pytest.fixture(scope="module")
def group_quantizer():
    model = JGroupQuantizer(embed_dim=16, n_code_groups=4, n_codes=8)
    x = _rand(7, 2, 6, 16) * 0.05
    variables = model.init(jax.random.key(0), x)
    port = _load(GroupQuantizer(16, 4, 8), porting.group_quantizer_state_dict(variables))
    return model, variables, port, x


def test_group_quantizer(group_quantizer):
    """tests/test_parity_extras.py's sizes: codes bit-identical (B, G, T),
    the straight-through output, the loss and embed(codes)."""
    model, variables, port, x = group_quantizer
    zq, loss, codes = model.apply(variables, x)
    with torch.no_grad():
        pzq, ploss, pcodes = port(torch.from_numpy(x))
    assert pcodes.shape == (2, 4, 6)
    assert len(np.unique(np.asarray(codes))) > 2
    np.testing.assert_array_equal(pcodes.numpy(), np.asarray(codes))
    assert rel(pzq, zq) <= TOL and abs(ploss.item() - float(loss)) <= TOL * float(loss)
    with torch.no_grad():
        emb = port.embed(pcodes)
    np.testing.assert_array_equal(emb.numpy(), np.asarray(model.apply(variables, codes,
                                                                      method=model.embed)))
    back = porting.group_quantizer_variables(port.state_dict())
    np.testing.assert_array_equal(back["params"]["codebooks"],
                                  np.asarray(variables["params"]["codebooks"]))


def test_group_quantizer_gradients(group_quantizer):
    """The gradients of sum(zq^2) + loss with respect to x (through the
    straight-through estimator) and the codebooks."""
    model, variables, port, x = group_quantizer

    def loss_fn(params, x):
        zq, loss, _ = model.apply({"params": params}, x)
        return jnp.sum(zq ** 2) + loss

    g_params, g_x = jax.grad(loss_fn, argnums=(0, 1))(variables["params"], jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    zq, loss, _ = port(xt)
    (torch.sum(zq ** 2) + loss).backward()
    assert rel(xt.grad, g_x) <= GRAD_TOL
    got = np.stack([m.embedding.weight.grad.numpy() for m in port.quantizer_modules])
    assert np.abs(got).max() > 0 and rel(got, g_params["codebooks"]) <= GRAD_TOL


@pytest.mark.parametrize("norms", [False, True])
def test_tacotron_mel(norms):
    """tacotron_mel_spectrogram (22.05 kHz, 80 bins) and the min-max
    normalisation and its inverse."""
    audio = _rand(8, 2, 5000) * 0.3
    mel_norms = np.abs(_rand(9, 80)) + 0.5 if norms else None
    want = np.asarray(jmel.tacotron_mel_spectrogram(
        jnp.asarray(audio), mel_norms=None if mel_norms is None else jnp.asarray(mel_norms)))
    got = mel.tacotron_mel_spectrogram(
        torch.from_numpy(audio), mel_norms=None if mel_norms is None else torch.from_numpy(mel_norms))
    assert got.shape == want.shape == (2, 80, 5000 // 256 + 1)
    assert rel(got, want) <= MEL_TOL
    norm = mel.normalize_tacotron_mel_minmax(got)
    assert rel(norm, jmel.normalize_tacotron_mel_minmax(jnp.asarray(got.numpy()))) <= MEL_TOL
    torch.testing.assert_close(mel.denormalize_tacotron_mel_minmax(norm), got, rtol=1e-5,
                               atol=1e-5)
    assert (mel.TACOTRON_MEL_MAX, mel.TACOTRON_MEL_MIN) == (jmel.TACOTRON_MEL_MAX,
                                                            jmel.TACOTRON_MEL_MIN)


DT_KW = dict(model_channels=32, num_layers=3, in_channels=8, in_latent_channels=12,
             in_tokens=50, out_channels=16, num_heads=4, layer_drop=0.5,
             unconditioned_percentage=0.5)


def _injected(monkeypatch, uniform, keeps):
    """jax.random.uniform returns `uniform` (the unconditioned rows' draw),
    jax.random.bernoulli each layer's keep in turn."""
    it = iter(keeps)
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape, *a, **k: jnp.asarray(uniform))
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, *a, **k: jnp.asarray(next(it)))


@pytest.mark.parametrize("uncond_rows", [(True, False), (False, False)])
def test_diffusion_tts_training_forward(uncond_rows, monkeypatch):
    """DiffusionTts(train=True) with the draws injected: row 0 unconditioned
    (its mel prediction zeroed) or none, and layer 1 of the trunk's 0 < i <
    n - 1 dropped; then one backward, every gradient finite."""
    model = JDiffusionTts(**DT_KW)
    x, t = _rand(10, 2, 24, 8), np.asarray([10.0, 600.0], np.float32)
    codes = np.random.default_rng(11).integers(0, 50, (2, 10))
    cond = _rand(12, 2, 20, 8)
    variables = seeded_variables(lambda: model.init(jax.random.key(0), x, t, codes, cond), seed=3)
    uniform = np.where(np.asarray(uncond_rows), 0.0, 0.9).astype(np.float32)[:, None, None]
    n = DT_KW["num_layers"] + 3
    keeps = [i != 1 for i in range(1, n - 1)]
    _injected(monkeypatch, uniform, keeps)
    want, want_mel = jax.jit(lambda v: model.apply(
        v, x, t, codes, cond, return_code_pred=True, train=True,
        rngs={"uncond": jax.random.key(1), "layerdrop": jax.random.key(2)}))(variables)
    port = DiffusionTts(**DT_KW)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in
                          porting.diffusion_tts_state_dict(variables).items()})
    port.train()
    draws = dict(uncond=torch.tensor(uncond_rows), layer_keep=[True] + keeps + [True])
    out, mel_pred = port(*_t(x, t, codes, cond), return_code_pred=True, train=True, **draws)
    assert rel(out.detach(), want) <= DT_TOL and rel(mel_pred.detach(), want_mel) <= DT_TOL
    with torch.no_grad():
        out64, _ = port.double()(*(a.double() if a.is_floating_point() else a
                                   for a in _t(x, t, codes, cond)),
                                 return_code_pred=True, train=True, **draws)
        port.float()
    assert rel(out.detach(), out64) <= TOL
    if uncond_rows[0]:
        assert float(mel_pred[0].abs().max()) == 0.0 and float(mel_pred[1].abs().max()) > 0
    (out.square().mean() + mel_pred.square().mean()).backward()
    grads = [p.grad for p in port.parameters() if p.grad is not None]
    assert grads and all(torch.isfinite(g).all() for g in grads)
