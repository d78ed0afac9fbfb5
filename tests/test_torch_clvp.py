"""PyTorch port parity: CLVP (x-transformers flavour) against ttts_tpu's on
the CPU, in f32, weights carried through ttts_tpu_torch.porting.

Contract: similarities within 1e-5 relative to the largest |similarity| (f32,
summation order only; a similarity near 0 has no relative precision of its
own), and the same rerank winner over a candidate set whose margin exceeds
that."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_api import TINY
from test_torch_config import to_port
from ttts_tpu.models import porting as jporting
from ttts_tpu.models.clvp import CLVP as JaxCLVP
from ttts_tpu_torch import porting
from ttts_tpu_torch.models.clvp import CLVP

RTOL = 1e-5
CFGS = {"tiny": TINY.clvp,
        "deeper": dataclasses.replace(TINY.clvp, dim_text=64, dim_speech=64, text_heads=4,
                                      speech_heads=4, text_enc_depth=2, speech_enc_depth=2)}


@pytest.fixture(scope="module", params=sorted(CFGS))
def clvp(request):
    cfg = CFGS[request.param]
    model = JaxCLVP(cfg)
    variables = jax.jit(model.init)(jax.random.key(0), jnp.zeros((1, 8), jnp.int32),
                                    jnp.zeros((1, 16), jnp.int32))
    port = CLVP(to_port(cfg)).eval()
    port.load_state_dict({k: torch.as_tensor(v) for k, v in
                          porting.clvp_state_dict(variables).items()})
    return cfg, model, variables, port


def _tokens(seed, cfg, b=4, lt=16, ls=40):
    rng = np.random.default_rng(seed)
    return (rng.integers(1, cfg.num_text_tokens, (b, lt)).astype(np.int32),
            rng.integers(0, 1024, (b, ls)).astype(np.int32))


def _assert_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * np.abs(want).max())


def test_similarities(clvp):
    cfg, model, variables, port = clvp
    text, speech = _tokens(0, cfg)
    want = np.asarray(model.apply(variables, jnp.asarray(text), jnp.asarray(speech)))
    with torch.no_grad():
        got = port(torch.from_numpy(text).long(), torch.from_numpy(speech).long()).numpy()
    assert got.shape == (4,)
    _assert_close(got, want)


def test_masked_similarities(clvp):
    """With masks: the pair-masked plain attention and masked mean pooling."""
    cfg, model, variables, port = clvp
    text, speech = _tokens(1, cfg)
    tmask = np.arange(16)[None] < np.asarray([16, 9, 12, 3])[:, None]
    vmask = np.arange(40)[None] < np.asarray([40, 17, 25, 31])[:, None]
    want = np.asarray(model.apply(variables, jnp.asarray(text), jnp.asarray(speech),
                                  jnp.asarray(tmask), jnp.asarray(vmask)))
    with torch.no_grad():
        got = port(torch.from_numpy(text).long(), torch.from_numpy(speech).long(),
                   torch.from_numpy(tmask), torch.from_numpy(vmask)).numpy()
    _assert_close(got, want)


def test_rerank_winner(clvp):
    """One text against 4 candidate code sequences, as the rerank calls it:
    the same argmax, with a margin wider than the tolerance."""
    cfg, model, variables, port = clvp
    text, speech = _tokens(2, cfg)
    text = np.repeat(text[:1], 4, axis=0)
    want = np.asarray(model.apply(variables, jnp.asarray(text), jnp.asarray(speech)))
    with torch.no_grad():
        got = port(torch.from_numpy(text).long(), torch.from_numpy(speech).long()).numpy()
    top2 = np.sort(want)[-2:]
    assert top2[1] - top2[0] > 10 * RTOL * np.abs(want).max()
    assert int(np.argmax(got)) == int(np.argmax(want))


def test_converter_round_trip(clvp):
    cfg, _, variables, port = clvp
    sd = porting.clvp_state_dict(variables)
    assert set(sd) == set(port.state_dict())
    back = jporting.port_clvp_xformers_state(sd, cfg.text_enc_depth, cfg.speech_enc_depth)
    want = jax.tree_util.tree_map(np.asarray, variables["params"])
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, want)
