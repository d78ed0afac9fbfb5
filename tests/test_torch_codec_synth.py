"""PyTorch port parity: the codec's synthesis half (ttts_tpu_torch against
ttts_tpu) on the CPU, in f32, at TINY widths. Each module of the path
(windowed relative-position attention, the VITS transformer encoder, MRTE,
the text encoder, the coupling flow, the weight-normed transposed
convolution, the HiFi-GAN generator) and SynthesizerTrn.infer / .decode as a
whole, with JAX's z_p noise injected.

Weights: a JAX TINY SynthesizerTrn's variable shapes (jax.eval_shape of its
init, which compiles nothing) filled from a numpy seed at fan-in scales, so
that every part computes something (the reference zero-initialises the
flow's `post`, which would make the flow the identity), carried into the
port through ttts_tpu_torch.porting.synthesizer_trn_state_dict.

Contract (BASELINE.md:36-37): VQ codes bit-identical; activations and
waveform within 1e-3 relative (L2 over the tensor)."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_api import TINY
from test_torch_config import to_port
from ttts_tpu.models import blocks as jblocks
from ttts_tpu.models import porting as jporting
from ttts_tpu.models import vqvae as jvqvae
from ttts_tpu.models.quantize import RVQState
from ttts_tpu_torch import porting
from ttts_tpu_torch.models import blocks, vqvae

SPEC_CH = TINY.audio.filter_length // 2 + 1
HOP = TINY.audio.hop_length
C = TINY.vqvae
TOL = 1e-3


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _fill(path, shape, rng):
    """A seeded value for one flax leaf, by its name: kernels at 1/sqrt(fan
    in), scales (LayerNorm, weight-norm g) near 1, the relative tables at
    dk^-1/2, the rest small."""
    name = path[-1]
    if name == "kernel":
        return rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
    if name in ("scale", "g") or name.endswith("/kernel/scale"):
        return 1.0 + 0.1 * rng.standard_normal(shape)
    if name == "embedding":
        return rng.standard_normal(shape)
    if name in ("emb_rel_k", "emb_rel_v"):
        return rng.standard_normal(shape) * shape[-1] ** -0.5
    return 0.1 * rng.standard_normal(shape)


def seeded_variables(init, seed: int = 0):
    """The variables of the flax init call `init()`, their shapes taken with
    jax.eval_shape (nothing compiled) and each leaf filled by _fill from a
    numpy seed."""
    rng = np.random.default_rng(seed)
    flat = flax.traverse_util.flatten_dict(jax.eval_shape(init))
    return flax.traverse_util.unflatten_dict(
        {k: jnp.asarray(_fill(k, v.shape, rng), jnp.float32) for k, v in flat.items()})


def random_codec_variables(seed: int = 0):
    """A JAX TINY SynthesizerTrn (enc_q left out, as `infer` initialises
    it) and seeded variables for it, with a random codebook."""
    model = jvqvae.SynthesizerTrn(C, spec_channels=SPEC_CH, segment_frames=4)
    frames = 8
    wav, spec = jnp.zeros((1, frames * HOP, 1)), jnp.zeros((1, frames, SPEC_CH))
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.key(0), "noise": jax.random.key(1)}, wav, spec,
        jnp.asarray([frames]), jnp.zeros((1, 4), jnp.int32), jnp.asarray([4]),
        method=model.infer))
    rng = np.random.default_rng(seed)
    flat = flax.traverse_util.flatten_dict(shapes["params"])
    params = flax.traverse_util.unflatten_dict(
        {k: jnp.asarray(_fill(k, v.shape, rng), jnp.float32) for k, v in flat.items()})
    st = shapes["codebook"]["quantizer"]["state"]
    embed = jnp.asarray(rng.standard_normal(st.embed.shape), jnp.float32)
    state = RVQState(embed=embed, embed_avg=embed, cluster_size=jnp.ones(st.cluster_size.shape),
                     inited=jnp.asarray(True))
    return model, {"params": params, "codebook": {"quantizer": {"state": state}}}


def load_port(module: torch.nn.Module, fill, tree) -> torch.nn.Module:
    """module with the state dict that porting's `fill(sd, prefix, tree)` writes."""
    sd = {}
    fill(sd, "m", tree)
    module.load_state_dict({k[2:]: torch.from_numpy(v) for k, v in sd.items()})
    return module.eval()


@pytest.fixture(scope="module")
def codec():
    model, variables = random_codec_variables()
    port = vqvae.SynthesizerTrn(to_port(C), spec_channels=SPEC_CH).eval()
    port.load_state_dict({k: torch.from_numpy(v) for k, v in
                          porting.synthesizer_trn_state_dict(variables).items()})
    return model, variables, port


def _mask(lengths, t):
    return (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)[..., None]


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


# ---------------------------------------------------------------- modules


# window_size 4: T below (3), at (5) and above (9, 12) window_size + 1, with
# shared relative tables (JAX's heads_share default, every configuration's)
# and a padding mask on the second row
@pytest.mark.parametrize("t", [3, 5, 9, 12])
def test_windowed_attention(t):
    ch, h, w = 16, 2, 4
    jmod = jblocks.RelPosMultiHeadAttention(ch, ch, h, window_size=w)
    rng = np.random.default_rng(t)
    x = rng.standard_normal((2, t, ch)).astype(np.float32)
    m = _mask([t, t - 2], t)
    amask = m[:, None, :, 0][:, :, None, :] * m[:, None, :, 0][:, :, :, None]
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.key(0), x, x, amask))
    flat = flax.traverse_util.flatten_dict(shapes["params"])
    params = flax.traverse_util.unflatten_dict(
        {k: jnp.asarray(_fill(k, v.shape, rng), jnp.float32) for k, v in flat.items()})
    want = jmod.apply({"params": params}, x, x, amask)
    port = load_port(blocks.MultiHeadAttention(ch, ch, h, window_size=w),
                     porting._vits_mha, params)
    with torch.no_grad():
        got = port(*_t(x, x, amask))
    assert got.shape == (2, t, ch)
    assert rel(got, want) < TOL


def test_transformer_encoder(codec):
    _, variables, _ = codec
    tree = variables["params"]["enc_p_2"]["TransformerEncoder_1"]
    n = C.n_layers
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, C.hidden_channels)).astype(np.float32)
    m = _mask([7, 4], 7)
    want = jblocks.TransformerEncoder(C.hidden_channels, C.filter_channels, C.n_heads, n,
                                      C.kernel_size).apply({"params": tree}, x, m)
    port = load_port(blocks.TransformerEncoder(C.hidden_channels, C.filter_channels,
                                               C.n_heads, n, C.kernel_size),
                     porting._vits_encoder, tree)
    with torch.no_grad():
        got = port(*_t(x, m))
    assert rel(got, want) < TOL


def _text_inputs(rng, t=8, lt=7):
    y = rng.standard_normal((2, t, C.hidden_channels)).astype(np.float32)
    text = rng.integers(0, C.n_text_tokens, (2, lt))
    ge = rng.standard_normal((2, C.gin_channels)).astype(np.float32)
    return y, _mask([t, t - 4], t), text, _mask([lt, lt - 3], lt), ge


def test_mrte(codec):
    _, variables, port = codec
    tree = variables["params"]["enc_p_2"]["MRTE_0"]
    y, ym, _, tm, ge = _text_inputs(np.random.default_rng(2))
    txt = np.random.default_rng(3).standard_normal((2, tm.shape[1], C.hidden_channels)
                                                   ).astype(np.float32)
    want = jvqvae.MRTE(hidden_size=C.gin_channels, out_channels=C.hidden_channels).apply(
        {"params": tree}, y, ym, txt, tm, ge)
    with torch.no_grad():
        got = port.enc_p_2.mrte(*_t(y, ym, txt, tm, ge))
    assert rel(got, want) < TOL


def test_text_encoder(codec):
    _, variables, port = codec
    y, ym, text, tm, ge = _text_inputs(np.random.default_rng(4))
    jmod = jvqvae.TextEncoder(C.inter_channels, C.hidden_channels, C.filter_channels,
                              C.n_heads, C.n_layers, C.kernel_size, C.p_dropout,
                              n_text_tokens=C.n_text_tokens, mrte_hidden=C.gin_channels)
    want = jmod.apply({"params": variables["params"]["enc_p_2"]}, y, ym, text, tm, ge)
    with torch.no_grad():
        got = port.enc_p_2(*_t(y, ym, text, tm, ge))
    for g, w, name in zip(got, want, ("y", "m", "logs")):
        assert g.shape == w.shape and rel(g, w) < TOL, name


def test_coupling_flow_forward_and_reverse(codec):
    _, variables, port = codec
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, C.inter_channels)).astype(np.float32)
    m = _mask([8, 5], 8)
    ge = rng.standard_normal((2, C.gin_channels)).astype(np.float32)
    jmod = jvqvae.ResidualCouplingBlock(C.inter_channels, C.hidden_channels, 5, 1,
                                        C.flow_wn_layers, n_flows=C.flow_layers,
                                        gin_channels=C.gin_channels)
    tree = {"params": variables["params"]["flow"]}
    with torch.no_grad():
        for reverse in (False, True):
            want = jmod.apply(tree, x, m, g=ge, reverse=reverse)
            got = port.flow(*_t(x, m), g=torch.from_numpy(ge), reverse=reverse)
            assert rel(got, want) < TOL, reverse
            assert rel(got, x * m) > 1e-2  # the flow is not the identity
        back = port.flow(port.flow(*_t(x, m), g=torch.from_numpy(ge)), torch.from_numpy(m),
                         g=torch.from_numpy(ge), reverse=True)
    # identity on the valid frames (the couplings pass their first halves
    # through unmasked)
    np.testing.assert_allclose(back.numpy() * m, x * m, atol=1e-5, rtol=0)


@pytest.mark.parametrize("t,u,k", [(5, 10, 16), (7, 8, 16), (6, 2, 8), (4, 2, 2)])
def test_conv_transpose_weight_norm(t, u, k):
    """Each upsample of the generator (rates 10, 8, 2, 2 with kernels 16, 16,
    8, 2): the JAX module against the port's, both normalised per output
    channel, through porting's relayout; out length (T-1)*stride - 2p + k."""
    cin, cout, p = 6, 4, (k - u) // 2
    jmod = jblocks.ConvTranspose1d(cout, k, u, torch_padding=p, weight_norm=True)
    rng = np.random.default_rng(k + u)
    x = rng.standard_normal((2, t, cin)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.key(0), x))
    params = {n: jnp.asarray(_fill((n,), s.shape, rng), jnp.float32)
              for n, s in shapes["params"].items()}
    want = jmod.apply({"params": params}, x)
    port = load_port(blocks.ConvTranspose1d(cin, cout, k, u, padding=p, weight_norm=True),
                     porting._conv_transpose, params)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == want.shape == (2, (t - 1) * u - 2 * p + k, cout)
    assert rel(got, want) < TOL


def test_generator(codec):
    _, variables, port = codec
    rng = np.random.default_rng(6)
    z = rng.standard_normal((2, 8, C.inter_channels)).astype(np.float32)
    ge = rng.standard_normal((2, C.gin_channels)).astype(np.float32)
    jmod = jvqvae.Generator(C.inter_channels, C.resblock_kernel_sizes,
                            C.resblock_dilation_sizes, C.upsample_rates,
                            C.upsample_initial_channel, C.upsample_kernel_sizes,
                            gin_channels=C.gin_channels)
    want = jmod.apply({"params": variables["params"]["dec"]}, z, g=ge)
    with torch.no_grad():
        got = port.dec(*_t(z), g=torch.from_numpy(ge))
    assert got.shape == want.shape == (2, 8 * HOP, 1)
    assert rel(got, want) < TOL


def _reference_ups(sd):
    """The port's state dict with dec's transposed convolutions in the
    reference's torch weight norm (per input channel), the JAX porter's
    input: the effective weight v * g / ||v|| as v, g its per-input norm."""
    sd = dict(sd)
    for k in [k for k in sd if k.startswith("dec.ups.") and k.endswith(".weight_v")]:
        p = k[:-len(".weight_v")]
        v, g = sd[p + ".weight_v"].astype(np.float64), sd[p + ".weight_g"]
        w = v * g / np.sqrt((v ** 2).sum(axis=(0, 2), keepdims=True))
        sd[p + ".weight_v"] = w.astype(np.float32)
        sd[p + ".weight_g"] = np.sqrt((w ** 2).sum(axis=(1, 2), keepdims=True)).astype(np.float32)
    return sd


def test_converter_round_trip(codec):
    """porting.synthesizer_trn_state_dict inverts the JAX porter for every
    part the port builds: exactly, but for dec's transposed convolutions,
    which the port keeps in JAX's weight norm (per output channel): moved
    into the reference's, their effective weights kernel * g / ||kernel||
    agree."""
    _, variables, port = codec
    sd = porting.synthesizer_trn_state_dict(variables)
    assert set(sd) == set(port.state_dict())
    sd = _reference_ups(sd)
    sd_enc_q = {k.replace("enc_p.", "enc_q.", 1): v for k, v in sd.items()
                if k.startswith("enc_p.")}
    back = jporting.port_synthesizer_trn_state(
        {**sd, **sd_enc_q}, n_layers=C.n_layers, n_flows=C.flow_layers,
        flow_wn_layers=C.flow_wn_layers, posterior_wn_layers=C.posterior_wn_layers)
    flat = lambda t: {"/".join(k): np.asarray(v) for k, v in  # noqa: E731
                      flax.traverse_util.flatten_dict(t).items()}
    for name in ("ref_enc", "enc_p", "enc_p_2", "flow", "dec", "proj"):
        want, got = flat(variables["params"][name]), flat(back["params"][name])
        assert set(got) == set(want), name
        for k in want:
            if "ConvTranspose1d" in k and not k.endswith("bias"):
                continue
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name}/{k}")
    for i in range(len(C.upsample_rates)):
        eff = []
        for tree in (variables["params"]["dec"], back["params"]["dec"]):
            ct = tree[f"ConvTranspose1d_{i}"]
            kern = np.asarray(ct["kernel"], np.float64)
            norm = np.sqrt((kern.reshape(-1, kern.shape[-1]) ** 2).sum(0))
            eff.append(kern * np.asarray(ct["g"]) / norm)
        np.testing.assert_allclose(eff[1], eff[0], rtol=1e-5, atol=1e-7)


# ------------------------------------------------------- infer and decode


# the shapes of the module tests above (8 frames, 7 text tokens), so that
# JAX's eager op cache serves both
def _codec_inputs(frames=8, seed=7):
    rng = np.random.default_rng(seed)
    wav = (rng.standard_normal((2, frames * HOP, 1)) * 0.1).astype(np.float32)
    spec = np.abs(rng.standard_normal((2, frames, SPEC_CH))).astype(np.float32)
    text = rng.integers(0, C.n_text_tokens, (2, 7))
    return wav, spec, np.asarray([frames, frames - 2]), text, np.asarray([7, 5])


def _jax_with_noise(monkeypatch, fn):
    """fn() with jax.random.normal recorded: (fn's result, the draws)."""
    draws, normal = [], jax.random.normal

    def spy(key, shape, *args, **kwargs):
        draws.append(np.array(normal(key, shape, *args, **kwargs)))
        return draws[-1]

    monkeypatch.setattr(jax.random, "normal", spy)
    out = np.asarray(fn())
    monkeypatch.setattr(jax.random, "normal", normal)
    return out, draws


def test_infer_and_decode_match_jax(codec, monkeypatch):
    model, variables, port = codec
    wav, spec, lengths, text, tl = _codec_inputs()
    y_mask = _mask(lengths, spec.shape[1])
    # the content path: the quantizer's eval forward (the VQ kernel on the card)
    ge = model.apply(variables, spec * y_mask, y_mask,
                     method=lambda m, s, y: m.ref_enc(s, y))
    jq, jcodes, _ = model.apply(variables, spec, wav, y_mask, ge, False,
                                method=model._content_codes)
    with torch.no_grad():
        pge = port.ref_enc(*_t(spec * y_mask, y_mask))
        pq, pcodes = port._content_codes(*_t(spec, wav, y_mask), pge)
    assert rel(pge, ge) < TOL
    assert len(np.unique(np.asarray(jcodes))) > 1
    np.testing.assert_array_equal(pcodes.numpy(), np.asarray(jcodes))
    assert rel(pq, jq) < TOL

    want, draws = _jax_with_noise(monkeypatch, lambda: model.apply(
        variables, wav, spec, lengths, text, tl, 0.5, method=model.infer,
        rngs={"noise": jax.random.key(3)}))
    assert len(draws) == 1 and draws[0].shape == (2, spec.shape[1], C.inter_channels)
    with torch.no_grad():
        got = port.infer(*_t(wav, spec, lengths, text, tl), 0.5,
                         noise=torch.from_numpy(draws[0]))
    assert got.shape == want.shape == wav.shape
    assert np.isfinite(got.numpy()).all() and rel(got, want) < TOL

    codes = np.asarray(jcodes)
    want, draws = _jax_with_noise(monkeypatch, lambda: model.apply(
        variables, codes, text, spec, 0.7, method=model.decode,
        rngs={"noise": jax.random.key(4)}))
    with torch.no_grad():
        got = port.decode(*_t(codes, text, spec), 0.7, noise=torch.from_numpy(draws[0]))
    assert got.shape == want.shape == (2, 2 * codes.shape[2] * HOP, 1)
    assert rel(got, want) < TOL


def test_infer_draws_from_the_generator(codec):
    """Without injected noise, infer draws z_p's noise from the generator:
    the same seed gives the same waveform, another seed another."""
    _, _, port = codec
    args = _t(*_codec_inputs())
    with torch.no_grad():
        a, b, c = (port.infer(*args, 0.5, generator=torch.Generator().manual_seed(s))
                   for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_odd_frame_count_raises_in_both(codec):
    """The stride-2 content path gives 2*floor(T/2) frames: the JAX
    package's infer fails to broadcast them against its T-frame masks, and
    the port refuses the odd count before it starts."""
    model, variables, port = codec
    wav, spec, lengths, text, tl = _codec_inputs(frames=9)
    with pytest.raises((TypeError, ValueError)):  # traced only: the shapes fail
        jax.eval_shape(lambda: model.apply(variables, wav, spec, lengths, text, tl, 0.5,
                                           method=model.infer,
                                           rngs={"noise": jax.random.key(0)}))
    with pytest.raises(ValueError, match="even"):
        port.infer(*_t(wav, spec, lengths, text, tl), 0.5)
