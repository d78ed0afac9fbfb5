"""PyTorch port parity: the no-bias and causal modes of the flash-attention
wrapper (what ttts_tpu_torch.ops.cuda.attention runs on a CPU tensor)
against the Pallas kernel in interpret mode, and at ragged T, which the
Pallas kernel refuses (T % 128), against an einsum with an explicit mask.
Tolerance 1e-5 in f32 (summation order only). The bias mode is held in
tests/test_torch_diffusion.py."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ttts_tpu.ops.pallas.attention import flash_attention as jflash
from ttts_tpu_torch.ops.cuda.attention import _strides, flash_attention

MODES = {"nobias": (False, False), "causal": (False, True), "bias_causal": (True, True)}


def _inputs(seed, b, t, h, d):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3))
    return q, k, v, (rng.standard_normal((h, 2 * t - 1)) * 0.5).astype(np.float32)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("b,t,h,d", [(2, 128, 4, 16), (1, 256, 2, 32)])
def test_plain_matches_pallas(mode, b, t, h, d):
    use_strip, causal = MODES[mode]
    q, k, v, strip = _inputs(t + d, b, t, h, d)
    want = jflash(*map(jnp.asarray, (q, k, v)), strip=jnp.asarray(strip) if use_strip else None,
                  scale=d ** -0.5, causal=causal, interpret=True)
    got = flash_attention(*map(torch.from_numpy, (q, k, v)),
                          torch.from_numpy(strip) if use_strip else None, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def _masked_einsum(q, k, v, strip, causal):
    """numpy reference: softmax(q.k^T / sqrt(D) [+ bias], keys j > i dropped
    when causal) . v, in f64."""
    t, d = q.shape[1], q.shape[3]
    s = np.einsum("bthd,bshd->bhts", q.astype(np.float64), k) / math.sqrt(d)
    if strip is not None:
        i = np.arange(t)
        s = s + strip[:, i[None, :] - i[:, None] + t - 1][None]
    if causal:
        s = np.where(np.tril(np.ones((t, t), bool)), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("bhts,bshd->bthd", p / p.sum(-1, keepdims=True), v)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("t", [37, 163, 400])
def test_plain_at_ragged_t_matches_masked_einsum(mode, t):
    use_strip, causal = MODES[mode]
    q, k, v, strip = _inputs(t, 2, t, 2, 64)
    want = _masked_einsum(q, k, v, strip if use_strip else None, causal)
    got = flash_attention(*map(torch.from_numpy, (q, k, v)),
                          torch.from_numpy(strip) if use_strip else None, causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("mode", ["bias", "bias_causal", "causal", "nobias"])
@pytest.mark.parametrize("t", [64, 65, 129])
@pytest.mark.parametrize("d", [32, 64])
def test_plain_at_tile_edges_matches_masked_einsum(mode, t, d):
    """One exact 64-key tile, a last tile of one key, and a third tile of
    one key (the kernel's ring refilled), in every mode at both head widths
    the kernel takes."""
    use_strip, causal = {"bias": (True, False), **MODES}[mode]
    q, k, v, strip = _inputs(t * d, 2, t, 3, d)
    strip = strip if use_strip else None
    want = _masked_einsum(q, k, v, strip, causal)
    got = flash_attention(*map(torch.from_numpy, (q, k, v)),
                          None if strip is None else torch.from_numpy(strip), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_strides_of_the_models_qkv_views():
    """The kernel reads q, k, v through (token, head) strides: the GPT's
    [q; k; v] split and the diffusion trunk's per-head [q; k; v] split both
    pass, a view whose D is not contiguous does not."""
    b, t, h, d = 2, 5, 4, 16
    gpt = torch.zeros(b, t, 3 * h * d)
    q = gpt[..., h * d: 2 * h * d].reshape(b, t, h, d)
    assert _strides(q, "q") == (3 * h * d, d)
    trunk = torch.zeros(b, t, h, 3 * d)
    assert _strides(trunk[..., d: 2 * d], "k") == (h * 3 * d, 3 * d)
    assert _strides(torch.zeros(b, t, h, d), "v") == (h * d, d)
    with pytest.raises(ValueError, match="contiguous"):
        _strides(torch.zeros(b, t, d, h).transpose(2, 3), "q")
