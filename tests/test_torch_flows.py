"""PyTorch port parity of models/flows.py (ttts_tpu_torch against
ttts_tpu) on the CPU, in f32, at tests/test_flows.py's sizes: each flow's
forward (y, logdet) and reverse, the rational-quadratic spline with its
tails in both directions, and the converters' round trip. Weights: seeded
fills of JAX's variable shapes (ConvFlow's zero-initialised proj made
non-zero, so that the spline is not the identity); ActNorm's values and
InvConvNear's orthogonal init come from JAX. Limits, relative (L2), from
the largest of three readings (seed offsets 0-2): TOL 1e-5 for the flows,
read 1.8e-6 (ConvFlow); SPLINE_TOL 5e-5 for the spline, whose inverse
takes a root of a difference of products and read 1.9e-6, 4.2e-7 and
1.1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_codec_synth import rel, seeded_variables
from ttts_tpu.models import flows as jflows
from ttts_tpu_torch import porting
from ttts_tpu_torch.models import flows

TOL, SPLINE_TOL = 1e-5, 5e-5


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _mask(b, t, valid):
    return (np.arange(t)[None, :] < np.asarray(valid)[:, None]).astype(np.float32)[..., None]


def _port(module, variables):
    sd = porting.flow_state_dict(variables)
    assert set(sd) == set(module.state_dict()), set(sd) ^ set(module.state_dict())
    module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    back = porting.flow_variables(module.state_dict())
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, variables)))
    return module.eval()


def _close(got, want, tol=TOL):
    assert tuple(got.shape) == tuple(np.shape(want)) and rel(got, want) <= tol


# name: (JAX module, port module, input shape (B, T, C))
CASES = {
    "elementwise_affine": (lambda: jflows.ElementwiseAffine(4),
                           lambda: flows.ElementwiseAffine(4), (2, 6, 4)),
    "conv_flow": (lambda: jflows.ConvFlow(4, 16, 3, 2), lambda: flows.ConvFlow(4, 16, 3, 2),
                  (2, 8, 4)),
    "actnorm": (lambda: jflows.ActNorm(4), lambda: flows.ActNorm(4), (2, 6, 4)),
    "inv_conv_near": (lambda: jflows.InvConvNear(8, n_split=4),
                      lambda: flows.InvConvNear(8, n_split=4), (2, 6, 8)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_flow_forward_and_reverse(name):
    make_j, make_p, shape = CASES[name]
    model = make_j()
    x = _rand(0, *shape) * 2
    mask = _mask(shape[0], shape[1], [shape[1], shape[1] - 2])
    if name == "inv_conv_near":  # its orthogonal init, from JAX
        variables = jax.tree_util.tree_map(np.asarray, model.init(jax.random.key(3), x, mask))
    else:
        variables = seeded_variables(lambda: model.init(jax.random.key(0), x, mask))
    port = _port(make_p(), variables)
    y, logdet = model.apply(variables, x, mask)
    back = model.apply(variables, np.asarray(y), mask, reverse=True)
    with torch.no_grad():
        py, plogdet = port(torch.from_numpy(x), torch.from_numpy(mask))
        pback = port(py, torch.from_numpy(mask), reverse=True)
    _close(py, y)
    if name == "inv_conv_near":  # det +1: logdet 0 in both, up to rounding
        np.testing.assert_allclose(plogdet.numpy(), np.asarray(logdet), atol=1e-5)
    else:
        _close(plogdet, logdet)
    _close(pback, back)
    want = x * mask
    if name == "conv_flow":  # the coupling's first half passes unmasked
        want[..., :shape[2] // 2] = x[..., :shape[2] // 2]
    np.testing.assert_allclose(pback.numpy(), want, atol=1e-4)


def test_log_flow():
    x = np.abs(_rand(1, 2, 5, 3)) + 0.1
    mask = _mask(2, 5, [5, 3])
    y, logdet = jflows.LogFlow()(x, mask)
    py, plogdet = flows.LogFlow()(torch.from_numpy(x), torch.from_numpy(mask))
    _close(py, y)
    _close(plogdet, logdet)
    _close(flows.LogFlow()(py, torch.from_numpy(mask), reverse=True),
           jflows.LogFlow()(np.asarray(y), mask, reverse=True))


def test_ddsconv_masked():
    model = jflows.DDSConv(6, 3, 2)
    x, mask = _rand(2, 2, 10, 6), _mask(2, 10, [7, 7])
    g = _rand(3, 2, 10, 6)
    variables = seeded_variables(lambda: model.init(jax.random.key(0), x, mask))
    port = _port(flows.DDSConv(6, 3, 2), variables)
    with torch.no_grad():
        for gg in (None, g):
            got = port(torch.from_numpy(x), torch.from_numpy(mask),
                       g=None if gg is None else torch.from_numpy(gg))
            _close(got, model.apply(variables, x, mask, g=gg))
            assert float(got[:, 7:].abs().max()) == 0.0


@pytest.mark.parametrize("inverse", [False, True])
def test_rational_quadratic_spline(inverse):
    """tests/test_flows.py's inputs: inside and beyond the tail bound of 5
    (the identity there), forward and inverse."""
    k = 8
    x = np.linspace(-8, 8, 33).astype(np.float32)
    uw, uh, ud = _rand(4, 33, k), _rand(5, 33, k), _rand(6, 33, k - 1)
    y, ld = jflows.rational_quadratic_spline(*map(jnp.asarray, (x, uw, uh, ud)),
                                             inverse=inverse)
    py, pld = flows.rational_quadratic_spline(*map(torch.from_numpy, (x, uw, uh, ud)),
                                              inverse=inverse)
    _close(py, y, SPLINE_TOL)
    _close(pld, ld, SPLINE_TOL)
    outside = np.abs(x) > 5.0
    np.testing.assert_array_equal(py.numpy()[outside], x[outside])
