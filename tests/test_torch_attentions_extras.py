"""PyTorch port parity of models/attentions_extras.py (ttts_tpu_torch
against ttts_tpu) on the CPU, in f32, at tests/test_attentions_extras.py's
sizes, held against ttts_tpu alone: the depthwise-separable convolution and
its transposed variant (with and without weight norm), FFT (plain and
flow-conditioned, with the proximal bias), the flow-conditioned encoder,
TransformerCouplingLayer (affine and mean-only, forward and reverse) and
the proximal-init ties.

Weights: seeded fills of each JAX module's variable shapes carried into
the port by ttts_tpu_torch.porting; its state dicts go back through JAX's
own porters (port_fft_state, port_transformer_coupling_state,
port_depthwise_separable_conv_state) to the same JAX params. TOL 1e-5
relative (L2): the largest of three readings (seed offsets 0-2) was
4.0e-7."""

import jax
import numpy as np
import pytest
import torch

from test_torch_codec_synth import rel, seeded_variables
from ttts_tpu.models import attentions_extras as jae
from ttts_tpu.models import porting as jporting
from ttts_tpu_torch import porting
from ttts_tpu_torch.models import attentions_extras as pae

TOL = 1e-5


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _mask(b, t, cut):
    m = np.ones((b, t, 1), np.float32)
    m[1, t - cut:] = 0.0
    return m


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _load(port, sd):
    assert set(sd) == set(port.state_dict()), set(sd) ^ set(port.state_dict())
    port.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return port.eval()


def _same_tree(got, want):
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v)  # noqa: E731
                      for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    got, want = flat(got), flat(want)
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _np_sd(port):
    return {k: v.numpy() for k, v in port.state_dict().items()}


@pytest.mark.parametrize("weight_norm", [False, True])
def test_depthwise_separable_conv(weight_norm):
    model = jae.DepthwiseSeparableConv1d(24, 5, padding=2, weight_norm=weight_norm)
    x = _rand(0, 2, 20, 16)
    variables = seeded_variables(lambda: model.init(jax.random.key(0), x))
    sd = porting.depthwise_separable_conv_state_dict(variables)
    port = _load(pae.DepthwiseSeparableConv1d(16, 24, 5, padding=2, weight_norm=weight_norm), sd)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == (2, 20, 24) and rel(got, model.apply(variables, x)) <= TOL
    _same_tree(jporting.port_depthwise_separable_conv_state(_np_sd(port)), variables["params"])
    _same_tree(porting.depthwise_separable_conv_variables(port.state_dict())["params"],
               variables["params"])


@pytest.mark.parametrize("weight_norm", [False, True])
def test_depthwise_separable_conv_transpose(weight_norm):
    """out_len = (T - 1) * 2 - 2 + 4; with weight norm JAX's porter fuses
    the depthwise weight, held through its effective value."""
    model = jae.DepthwiseSeparableConvTranspose1d(20, 4, stride=2, padding=1,
                                                  weight_norm=weight_norm)
    x = _rand(1, 2, 12, 16)
    variables = seeded_variables(lambda: model.init(jax.random.key(0), x))
    sd = porting.depthwise_separable_conv_state_dict(variables)
    port = _load(pae.DepthwiseSeparableConvTranspose1d(16, 20, 4, stride=2, padding=1,
                                                       weight_norm=weight_norm), sd)
    want = model.apply(variables, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 24, 20) and rel(got, want) <= TOL
    _same_tree(porting.depthwise_separable_conv_variables(port.state_dict(), transpose=True)
               ["params"], variables["params"])
    back = jporting.port_depthwise_separable_conv_state(_np_sd(port), transpose=True)
    if not weight_norm:
        _same_tree(back, variables["params"])
        return
    p = variables["params"]  # JAX's porter fuses the depthwise weight norm
    kern = np.asarray(p["depth_kernel"], np.float64)
    norm = np.sqrt((kern.reshape(-1, kern.shape[-1]) ** 2).sum(0))
    np.testing.assert_allclose(back["depth_kernel"], kern * np.asarray(p["depth_g"]) / norm,
                               rtol=1e-5, atol=1e-7)
    _same_tree(back["Conv1d_0"], p["Conv1d_0"])


@pytest.mark.parametrize("isflow", [False, True])
def test_fft(isflow):
    h, t = 64, 24
    model = jae.FFT(h, 128, 4, n_layers=2, kernel_size=3, isflow=isflow, proximal_bias=True,
                    gin_channels=32 if isflow else 0)
    x, mask, g = _rand(2, 2, t, h), _mask(2, t, 6), _rand(3, 2, t, 32)
    gj = g if isflow else None
    variables = seeded_variables(lambda: model.init(jax.random.key(0), x, mask, gj))
    port = _load(pae.FFT(h, 128, 4, n_layers=2, kernel_size=3, isflow=isflow, proximal_bias=True,
                         gin_channels=32 if isflow else 0),
                 porting.fft_state_dict(variables))
    want = model.apply(variables, x, mask, gj)
    x2 = x.copy()
    x2[0, 10] += 3.0
    with torch.no_grad():
        got = port(*_t(x, mask), g=torch.from_numpy(g) if isflow else None)
        got2 = port(*_t(x2, mask), g=torch.from_numpy(g) if isflow else None)
    assert rel(got, want) <= TOL
    torch.testing.assert_close(got[0, :10], got2[0, :10], atol=1e-5, rtol=0)
    assert float((got[0, 10:] - got2[0, 10:]).abs().max()) > 1e-3
    _same_tree(jporting.port_fft_state(_np_sd(port), n_layers=2, isflow=isflow),
               variables["params"])
    _same_tree(porting.fft_variables(port.state_dict())["params"], variables["params"])


@pytest.mark.parametrize("mean_only", [False, True])
def test_transformer_coupling_layer(mean_only):
    """Forward (y, logdet) and reverse back to x, with the flow-conditioned
    encoder's g; the post conv seeded (the reference zero-initialises it,
    which would make the coupling the identity)."""
    c, t = 8, 16
    model = jae.TransformerCouplingLayer(c, 48, 3, n_layers=2, n_heads=4, filter_channels=96,
                                         mean_only=mean_only, gin_channels=32)
    x, mask, g = _rand(4, 2, t, c), _mask(2, t, 4), _rand(5, 2, t, 32)
    variables = seeded_variables(lambda: model.init(jax.random.key(0), x, mask, g))
    port = _load(pae.TransformerCouplingLayer(c, 48, 3, 2, 4, filter_channels=96,
                                              mean_only=mean_only, gin_channels=32),
                 porting.transformer_coupling_state_dict(variables))
    y, logdet = model.apply(variables, x, mask, g)
    with torch.no_grad():
        py, plogdet = port(*_t(x, mask, g))
        back = port(py, torch.from_numpy(mask), torch.from_numpy(g), reverse=True)
    assert rel(py, y) <= TOL
    if mean_only:
        assert float(plogdet.abs().max()) == 0.0 and float(np.abs(logdet).max()) == 0.0
    else:
        assert rel(plogdet, logdet) <= TOL
    assert rel(back, model.apply(variables, y, mask, g, reverse=True)) <= TOL
    # the first half passes unmasked, the second comes back masked
    np.testing.assert_allclose(back.numpy(), np.concatenate([x[..., :c // 2],
                                                             x[..., c // 2:] * mask], -1),
                               atol=1e-4)
    _same_tree(jporting.port_transformer_coupling_state(_np_sd(port), n_layers=2),
               variables["params"])
    _same_tree(porting.transformer_coupling_variables(port.state_dict())["params"],
               variables["params"])


def test_flow_conditioned_encoder():
    model = jae.FlowConditionedEncoder(32, 64, 2, 2, kernel_size=3, gin_channels=16)
    x, mask, g = _rand(6, 2, 12, 32), _mask(2, 12, 3), _rand(7, 2, 12, 16)
    variables = seeded_variables(lambda: model.init(jax.random.key(0), x, mask, g))
    sd = {}
    porting._flow_cond(sd, "m.", variables["params"])
    porting._vits_encoder(sd, "m", variables["params"])
    port = _load(pae.FlowConditionedEncoder(32, 64, 2, 2, kernel_size=3, gin_channels=16),
                 {k[2:]: v for k, v in sd.items()})
    with torch.no_grad():
        got = port(*_t(x, mask), g=torch.from_numpy(g))
    assert rel(got, model.apply(variables, x, mask, g)) <= TOL


def test_proximal_init_ties():
    """tie_proximal_init / fft_tie_proximal_init copy conv_q onto conv_k of
    every self-attention, as JAX's do on its params."""
    model = jae.FFT(32, 64, 2, n_layers=2)
    x, mask = _rand(8, 1, 8, 32), np.ones((1, 8, 1), np.float32)
    variables = seeded_variables(lambda: model.init(jax.random.key(0), x, mask))
    port = _load(pae.FFT(32, 64, 2, n_layers=2), porting.fft_state_dict(variables))
    assert pae.fft_tie_proximal_init(port) is port
    want = jae.fft_tie_proximal_init(variables)
    _same_tree(porting.fft_variables(port.state_dict())["params"], want["params"])
    mha = port.self_attn_layers[0]
    torch.testing.assert_close(mha.conv_k.weight, mha.conv_q.weight, rtol=0, atol=0)
