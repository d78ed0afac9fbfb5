"""PyTorch port parity: the GPT's alternative conditioning encoders
(ConditioningEncoder, MelEncoder, PerceiverResampler) and the Tortoise-v1
diffusion decoder DiffusionTts against ttts_tpu's on the CPU, in f32.

Weights: seeded fills of each JAX module's variable shapes (the reference
zero-initialises every attention projection and the last conv, which would
hide them). Contract: outputs within 1e-3 relative (L2); the converters
carry every JAX value into the state dict once, under the port's keys."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_codec_synth import rel, seeded_variables
from ttts_tpu.models import conditioning as jcond
from ttts_tpu.models.diffusion_tts_v1 import DiffusionTts as JaxDiffusionTts
from ttts_tpu_torch import porting
from ttts_tpu_torch.models import conditioning
from ttts_tpu_torch.models.diffusion_tts_v1 import DiffusionTts

TOL = 1e-3


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _load(port, sd, variables):
    assert set(sd) == set(port.state_dict())
    flat = np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(variables)])
    np.testing.assert_array_equal(np.sort(np.concatenate([v.ravel() for v in sd.values()])),
                                  np.sort(flat))
    port.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return port.eval()


def _check(got, want):
    assert got.shape == want.shape and np.isfinite(got.numpy()).all()
    assert rel(got, want) < TOL


@pytest.mark.parametrize("mean", [False, True])
def test_conditioning_encoder(mean):
    model = jcond.ConditioningEncoder(16, 32, attn_blocks=2, num_attn_heads=2, mean=mean)
    mel = _rand(0, 2, 20, 16)
    variables = seeded_variables(lambda: model.init(jax.random.key(0), jnp.asarray(mel)))
    port = _load(conditioning.ConditioningEncoder(16, 32, 2, 2, mean),
                 porting.conditioning_encoder_state_dict(variables), variables)
    with torch.no_grad():
        _check(port(torch.from_numpy(mel)), model.apply(variables, jnp.asarray(mel)))


# T=21: each stride-2 "SAME" conv pads (1, 1) (21 → 11 → 6); T=20: each (0, 1) (20 → 10 → 5)
@pytest.mark.parametrize("t", [20, 21])
def test_mel_encoder(t):
    model = jcond.MelEncoder(64, 16, resblocks_per_reduction=1)
    mel = _rand(t, 2, t, 16)
    variables = seeded_variables(lambda: model.init(jax.random.key(0), jnp.asarray(mel)))
    port = _load(conditioning.MelEncoder(64, 16, 1),
                 porting.mel_encoder_state_dict(variables), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(mel))
    assert got.shape == (2, -(-(-(-t // 2)) // 2), 64)
    _check(got, model.apply(variables, jnp.asarray(mel)))


@pytest.mark.parametrize("masked", [False, True])
def test_perceiver_resampler(masked):
    model = jcond.PerceiverResampler(32, depth=2, num_latents=4, dim_head=8, heads=2)
    x = _rand(1, 2, 10, 32)
    mask = np.arange(10)[None] < np.asarray([10, 6])[:, None]
    variables = seeded_variables(lambda: model.init(jax.random.key(0), jnp.asarray(x)))
    port = _load(conditioning.PerceiverResampler(32, depth=2, num_latents=4, dim_head=8,
                                                 heads=2),
                 porting.perceiver_resampler_state_dict(variables), variables)
    args = (x, mask) if masked else (x,)
    with torch.no_grad():
        got = port(*map(torch.from_numpy, args))
    _check(got, model.apply(variables, *map(jnp.asarray, args)))


KW = dict(model_channels=32, num_layers=2, in_channels=8, in_latent_channels=12,
          in_tokens=50, out_channels=16, num_heads=4)


@pytest.fixture(scope="module")
def tts_v1():
    model = JaxDiffusionTts(**KW)
    args = (jnp.zeros((2, 24, 8)), jnp.asarray([1.0, 2.0]), jnp.zeros((2, 6, 12)),
            jnp.zeros((2, 20, 8)))
    variables = seeded_variables(lambda: model.init(jax.random.key(0), *args), seed=2)
    port = _load(DiffusionTts(**KW), porting.diffusion_tts_state_dict(variables), variables)
    return model, variables, port


def _inputs(seed, cond_len=21):
    return (_rand(seed, 2, 24, 8), np.asarray([10.0, 600.0], np.float32),
            _rand(seed + 1, 2, 6, 12), _rand(seed + 2, 2, cond_len, 8))


def test_latent_conditioning(tts_v1):
    """An AR latent and a conditioning mel (T=21: both strided convs pad
    (1, 1), flax's "SAME")."""
    model, variables, port = tts_v1
    x, t, latent, cond_mel = _inputs(0)
    want = model.apply(variables, *map(jnp.asarray, (x, t, latent, cond_mel)))
    with torch.no_grad():
        got = port(*map(torch.from_numpy, (x, t, latent, cond_mel)))
    assert np.abs(np.asarray(want)).max() > 0.1
    _check(got, want)


def test_code_conditioning_and_mel_pred(tts_v1):
    """Codes and a conditioning mel of T=20 (both strided convs pad (0, 1))."""
    model, variables, port = tts_v1
    x, t, _, cond_mel = _inputs(3, cond_len=20)
    codes = np.random.default_rng(1).integers(0, 50, (2, 10))
    want, want_mel = model.apply(variables, *map(jnp.asarray, (x, t, codes, cond_mel)),
                                 return_code_pred=True)
    with torch.no_grad():
        got, got_mel = port(*map(torch.from_numpy, (x, t, codes, cond_mel)),
                            return_code_pred=True)
    _check(got, want)
    _check(got_mel, want_mel)


def test_conditioning_free_and_precomputed(tts_v1):
    """The unconditioned embedding, and timestep_independent's embedding
    passed back in (from get_conditioning's (B, 2 ch))."""
    model, variables, port = tts_v1
    x, t, latent, cond_mel = _inputs(6)
    want = model.apply(variables, jnp.asarray(x), jnp.asarray(t), conditioning_free=True)
    cl = model.apply(variables, jnp.asarray(cond_mel), method=model.get_conditioning)
    emb = model.apply(variables, jnp.asarray(latent), cl, 24, method=model.timestep_independent)
    want2 = model.apply(variables, jnp.asarray(x), jnp.asarray(t),
                        precomputed_aligned_embeddings=emb)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t), conditioning_free=True)
        pcl = port.get_conditioning(torch.from_numpy(cond_mel))
        pemb = port.timestep_independent(torch.from_numpy(latent), pcl, 24)
        got2 = port(torch.from_numpy(x), torch.from_numpy(t),
                    precomputed_aligned_embeddings=pemb)
    _check(got, want)
    _check(pcl, cl)
    _check(pemb, emb)
    _check(got2, want2)


def test_training_forward_raises(tts_v1):
    """The training forward is ported (tests/test_torch_blocks_extras.py
    holds it to JAX's with the draws injected); without injected draws it
    takes them from the generator: the same seed gives the same output,
    and train=False ignores injected draws."""
    _, _, port = tts_v1
    args = list(map(torch.from_numpy, _inputs(0)))
    with torch.no_grad():
        a, b = (port(*args, train=True, generator=torch.Generator().manual_seed(4))
                for _ in range(2))
        plain = port(*args)
        ignored = port(*args, uncond=torch.tensor([True, True]), layer_keep=[False] * 5)
    assert torch.equal(a, b) and torch.isfinite(a).all()
    assert torch.equal(plain, ignored)
