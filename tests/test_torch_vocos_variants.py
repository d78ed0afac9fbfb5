"""PyTorch port parity: MDCT / IMDCT and the Vocos variants that `Vocos`
does not select (VocosResNetBackbone, IMDCTSymExpHead, IMDCTCosHead)
against ttts_tpu's on the CPU, in f32.

Contract: mdct / imdct within 1e-5 relative to the largest value, for both
paddings (the port's twiddle factors are float64-built, JAX's f32); each
variant's waveform within 1e-3 relative (L2); imdct(mdct(x)) equal to x
away from the edges, as ttts_tpu's test_mdct holds JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_api import TINY
from test_torch_codec_synth import rel, seeded_variables
from test_torch_config import to_port
from ttts_tpu.models import vocos as jvocos
from ttts_tpu.ops import mdct as jmdct
from ttts_tpu_torch import porting
from ttts_tpu_torch.models import vocos
from ttts_tpu_torch.ops import mdct

FRAME = 64
C = TINY.vocos


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("padding", ["same", "center"])
def test_mdct_and_imdct_match_jax(padding):
    x = _rand(0, 2, FRAME * 20, scale=0.5)
    want = np.array(jmdct.mdct(jnp.asarray(x), FRAME, padding))
    got = mdct.mdct(torch.from_numpy(x), FRAME, padding)
    _close(got, want, 1e-5)
    _close(mdct.imdct(torch.from_numpy(want), FRAME, padding),
           jmdct.imdct(jnp.asarray(want), FRAME, padding), 1e-5)
    # TDAC: the interior reconstructs exactly, the edges lack an overlap
    y = mdct.imdct(got, FRAME, padding).numpy()
    m = slice(FRAME, -FRAME)
    np.testing.assert_allclose(y[:, m][:, : x.shape[1] - 2 * FRAME], x[:, m], atol=1e-4)


def test_mdct_refuses_other_paddings():
    with pytest.raises(ValueError):
        mdct.mdct(torch.zeros(1, 256), FRAME, "valid")


@pytest.fixture(scope="module")
def backbone():
    model = jvocos.VocosResNetBackbone(C, num_blocks=2)
    variables = seeded_variables(lambda: model.init(
        jax.random.key(0), jnp.zeros((1, 12, C.input_channels))), seed=1)
    port = vocos.VocosResNetBackbone(to_port(C), num_blocks=2).eval()
    port.load_state_dict({k: torch.from_numpy(v) for k, v in
                          porting.vocos_resnet_backbone_state_dict(variables).items()})
    return model, variables, port


def _values(variables):
    return np.sort(np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(variables)]))


def test_resnet_backbone(backbone):
    """Dilations 1, 3, 5 with "SAME" padding, leaky ReLU 0.1, per-output
    weight norm, layer scale."""
    model, variables, port = backbone
    mel = _rand(2, 2, 40, C.input_channels)
    want = model.apply(variables, jnp.asarray(mel))
    with torch.no_grad():
        got = port(torch.from_numpy(mel))
    assert got.shape == (2, 40, C.dim) and rel(got, want) < 1e-3


def test_backbone_values_round_trip(backbone):
    """Every JAX value lands in the state dict once (the gammas as (dim, 1)),
    under the port's keys exactly."""
    _, variables, port = backbone
    sd = porting.vocos_resnet_backbone_state_dict(variables)
    assert set(sd) == set(port.state_dict())
    assert sd["resnet.1.gamma.2"].shape == (C.dim, 1)
    np.testing.assert_array_equal(np.sort(np.concatenate([v.ravel() for v in sd.values()])),
                                  _values(variables))


@pytest.mark.parametrize("head,padding,clip", [("IMDCTSymExpHead", "same", False),
                                               ("IMDCTSymExpHead", "center", True),
                                               ("IMDCTCosHead", "same", False),
                                               ("IMDCTCosHead", "center", False)])
def test_imdct_head_waveform(backbone, head, padding, clip):
    """The ResNet backbone's features through each IMDCT head: waveform
    within 1e-3 of JAX's (clip_audio clamps it to [-1, 1] in both)."""
    bmodel, bvars, bport = backbone
    jhead = getattr(jvocos, head)(FRAME, padding=padding, clip_audio=clip)
    feats = bmodel.apply(bvars, jnp.asarray(_rand(3, 2, 30, C.input_channels)))
    hvars = seeded_variables(lambda: jhead.init(jax.random.key(0), feats), seed=4)
    port = getattr(vocos, head)(C.dim, FRAME, padding=padding, clip_audio=clip).eval()
    sd = porting.imdct_head_state_dict(hvars)
    assert set(sd) == set(port.state_dict())
    np.testing.assert_array_equal(np.sort(np.concatenate([v.ravel() for v in sd.values()])),
                                  _values(hvars))
    port.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    want = jhead.apply(hvars, feats)
    with torch.no_grad():
        got = port(bport(torch.from_numpy(_rand(3, 2, 30, C.input_channels))))
    trim = FRAME // 2 if padding == "center" else FRAME // 4
    assert got.shape == want.shape == (2, 31 * FRAME // 2 - 2 * trim)
    assert np.isfinite(got.numpy()).all() and rel(got, want) < 1e-3
    assert not clip or np.abs(got.numpy()).max() <= 1.0


def test_vocos_selects_neither_variant():
    """Vocos is the ConvNeXt backbone and the ISTFT head, as in JAX."""
    model = vocos.Vocos(to_port(C))
    assert isinstance(model.backbone, vocos.VocosBackbone)
    assert isinstance(model.head, vocos.ISTFTHead)
