"""PyTorch port parity: AA_diffusion (attention, fused resblock, trunk,
conditioning) and the DPM-Solver++(2M) sampler (ttts_tpu_torch against
ttts_tpu) on the CPU, in f32.

The attention output projections are zero-initialised, so every attention
block would add exactly 0 and hide a wrong attention: these tests give them
non-zero weights. Tolerances: 1e-4 on activations, 1e-5 on the kernels'
plain versions against the Pallas kernels in interpret mode, 1e-3 on the
sampled mel (30 solver steps of f32 drift). The samplers on an analytic
epsilon: 1e-5 relative (the port computes the schedule's scalars in
float64, the JAX package in f32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_api import TINY
from test_torch_config import to_port
from ttts_tpu.diffusion import get_ode_sampler as jget_ode_sampler
from ttts_tpu.diffusion.dpm import cfg_eps_fn as jcfg
from ttts_tpu.models import diffusion_net as jdn
from ttts_tpu.models import porting as jporting
from ttts_tpu.ops.pallas.attention import flash_attention as jflash
from ttts_tpu.ops.pallas.resblock import fused_gn_qkv as jgn_qkv
from ttts_tpu.ops.pallas.resblock import fused_scale_shift_resblock as jres_kernel
from ttts_tpu.ops.pallas.resblock import resblock_reference
from ttts_tpu_torch import porting
from ttts_tpu_torch.diffusion import cfg_eps_fn, get_ode_sampler, uni_pc_sample
from ttts_tpu_torch.models import diffusion_net as tdn
from ttts_tpu_torch.ops.cuda.attention import flash_attention
from ttts_tpu_torch.ops.cuda.resblock import fused_gn_qkv, fused_scale_shift_resblock

ATOL = 1e-4
C = TINY.diffusion_net
T = 32  # trunk length (mel frames)


def _nonzero_proj(params, key):
    """Random weights for every AttentionBlock `proj` (zero at init)."""
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    out = params
    for i, (path, leaf) in enumerate(flat):
        names = [getattr(p, "key", None) for p in path]
        if len(names) >= 2 and names[-2] == "proj":
            new = 0.1 * jax.random.normal(jax.random.fold_in(key, i), leaf.shape)
            out = _set(out, names, new)
    return out


def _set(tree, names, value):
    if len(names) == 1:
        return {**tree, names[0]: value}
    return {**tree, names[0]: _set(tree[names[0]], names[1:], value)}


@pytest.fixture(scope="module")
def net():
    model = jdn.AA_diffusion(C)
    mel = jnp.zeros((1, T, C.in_channels))
    variables = jax.jit(model.init)(jax.random.key(0), mel, jnp.asarray([1.0]),
                                    jnp.zeros((1, 16, C.in_latent_channels)), mel)
    variables = {"params": _nonzero_proj(variables["params"], jax.random.key(5))}
    port = tdn.AA_diffusion(to_port(C)).eval()
    port.load_state_dict({k: torch.from_numpy(v) for k, v in
                          porting.aa_diffusion_state_dict(variables).items()})
    return model, variables, port


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def test_attention_block_with_nonzero_proj(net):
    """Module level: torch AttentionBlock (strip bias, plain attention) vs the
    flax block on its einsum path."""
    model, variables, port = net
    x = _rand(0, 2, 40, C.model_channels)
    blk = jdn.AttentionBlock(C.model_channels, C.num_heads)
    p = {"params": variables["params"]["latent_conditioner_1"]}
    want = blk.apply(p, jnp.asarray(x))
    with torch.no_grad():
        got = port.latent_conditioner[1](torch.from_numpy(x))
    assert np.abs(np.asarray(want) - x).max() > 1e-2  # the attention really adds
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("b,t,h,d,causal", [(2, 128, 4, 16, False), (1, 256, 2, 32, False),
                                             (1, 128, 2, 64, False), (2, 128, 4, 32, True),
                                             (1, 256, 2, 64, True)])
def test_flash_attention_plain_matches_pallas(b, t, h, d, causal):
    """The bias mode, and bias + causal, at both trunk head widths (the
    Pallas kernel takes T % 128 == 0; ragged T is held against an einsum in
    tests/test_torch_attention.py)."""
    q, k, v = (_rand(i, b, t, h, d) for i in range(3))
    strip = _rand(3, h, 2 * t - 1)
    want = jflash(*map(jnp.asarray, (q, k, v)), strip=jnp.asarray(strip),
                  scale=d ** -0.5, causal=causal, interpret=True)
    got = flash_attention(*map(torch.from_numpy, (q, k, v, strip)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


# bf16 x, w1, w3 (the serving dtypes): the output is rounded to bf16 and so
# are both activations before their products, in a summation order that
# differs between the frameworks, so an output may land one bf16 step away
# (2^-7 of its value) and a flipped activation rounding moves it by far less
# than 1e-3 of max|want| (read: at most 4.9e-4 against max|want| 4.3)
BF16_STEP = 2.0 ** -7


@pytest.mark.parametrize("b,t,dtype", [(2, 16, "float32"), (2, 40, "float32"),
                                       (1, 136, "float32"), (2, 40, "bfloat16"),
                                       (1, 136, "bfloat16")])
def test_resblock_plain_matches_reference_and_pallas(b, t, dtype):
    """At a T that is no multiple of the card's 128-row tile (40, 136), at
    B = 1, and in bf16 against resblock_reference (f32: also the Pallas
    kernel in interpret mode, 1e-5)."""
    c = 128
    args = [_rand(0, b, t, c), 1 + _rand(1, c, scale=0.1), _rand(2, c, scale=0.1),
            _rand(3, c, c, scale=c ** -0.5), _rand(4, c, scale=0.1),
            1 + _rand(5, b, c, scale=0.1), _rand(6, b, c, scale=0.1),
            _rand(7, 3, c, c, scale=(3 * c) ** -0.5), _rand(8, c, scale=0.1)]
    jargs, targs = list(map(jnp.asarray, args)), list(map(torch.from_numpy, args))
    if dtype == "bfloat16":
        for i in (0, 3, 7):  # x, w1, w3
            jargs[i], targs[i] = jargs[i].astype(jnp.bfloat16), targs[i].to(torch.bfloat16)
    ref = np.asarray(resblock_reference(*jargs, groups=32).astype(jnp.float32))
    got = fused_scale_shift_resblock(*targs, groups=32).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
        ker = np.asarray(jres_kernel(*jargs, groups=32, interpret=True))
        np.testing.assert_allclose(got, ker, atol=1e-5, rtol=0)
    else:
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=1e-3 * np.abs(ref).max(), rtol=BF16_STEP)


@pytest.mark.parametrize("t,c", [(16, 128), (24, 512)])
def test_gn_qkv_plain_matches_pallas(t, c):
    """fused_gn_qkv's plain version (w as (in, out), the JAX layout) against
    the Pallas kernel in interpret mode, at C=512 the trunk's width."""
    b = 2
    args = (_rand(0, b, t, c), 1 + _rand(1, c, scale=0.1), _rand(2, c, scale=0.1),
            _rand(3, c, 3 * c, scale=c ** -0.5), _rand(4, 3 * c, scale=0.1))
    want = np.asarray(jgn_qkv(*map(jnp.asarray, args), groups=32, interpret=True))
    got = fused_gn_qkv(*map(torch.from_numpy, args), groups=32).numpy()
    assert got.shape == (b, t, 3 * c)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_attention_block_fused_gn_equals_unfused(net):
    """AttentionBlock(fused_gn=True) == fused_gn=False on the CPU, on a trunk
    block's weights (non-zero proj_out)."""
    _, _, port = net
    blk = port.layers[0].attn
    x = torch.from_numpy(_rand(9, 2, 48, C.model_channels))
    with torch.no_grad():
        want = blk(x)
        blk.fused_gn = True
        try:
            got = blk(x)
        finally:
            blk.fused_gn = False
    assert (want - x).abs().max() > 1e-2  # the attention really adds
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


def _trunk_jax(model, variables, x, ts, cond):
    biases = model.apply(variables, x.shape[1], x.shape[0], method=model.rel_biases)
    return model.apply(variables, x, ts, cond, rel_biases=biases, method=model.trunk)


def test_timestep_independent_and_trunk(net):
    model, variables, port = net
    latent = _rand(1, 2, 9, C.in_latent_channels)
    refer = _rand(2, 2, 20, C.in_channels)
    want_cond = model.apply(variables, jnp.asarray(latent), jnp.asarray(refer), T,
                            method=model.timestep_independent)
    x = _rand(3, 2, T, C.in_channels)
    ts = np.asarray([10.0, 937.5], np.float32)
    want = _trunk_jax(model, variables, jnp.asarray(x), jnp.asarray(ts), want_cond)
    with torch.no_grad():
        cond = port.timestep_independent(torch.from_numpy(latent), torch.from_numpy(refer), T)
        got = port.trunk(torch.from_numpy(x), torch.from_numpy(ts), cond)
    np.testing.assert_allclose(cond.numpy(), np.asarray(want_cond), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


SAMPLERS = ["dpm++2m", "unipc", "unipc_bh1"]


@pytest.mark.parametrize("sampler", SAMPLERS)
def test_dpm_sampler_with_injected_noise(net, sampler):
    """Each ODE sampler of get_ode_sampler through the TINY trunk, with CFG,
    against ttts_tpu.diffusion.get_ode_sampler's."""
    model, variables, port = net
    cond = _rand(4, 1, T, C.model_channels)
    noise = _rand(5, 1, T, C.in_channels)
    uncond = np.tile(np.asarray(variables["params"]["unconditioned_embedding"]), (1, T, 1))
    biases = model.apply(variables, T, 2, method=model.rel_biases)
    jtrunk = lambda x2, t2, e2: model.apply(  # noqa: E731
        variables, x2, t2, e2, rel_biases=biases, method=model.trunk)
    want = jget_ode_sampler(sampler)(jcfg(jtrunk, jnp.asarray(cond), jnp.asarray(uncond), 2.0),
                                     jnp.asarray(noise), steps=30)
    with torch.no_grad():
        strips = port.rel_biases(T)
        eps = cfg_eps_fn(lambda x2, t2, e2: port.trunk(x2, t2, e2, strips),
                         torch.from_numpy(cond), port.unconditioned(1, T), 2.0)
        got = get_ode_sampler(sampler)(eps, torch.from_numpy(noise), steps=30)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=0)


@pytest.mark.parametrize("steps", [2, 3, 30])
@pytest.mark.parametrize("sampler", ["unipc", "unipc_bh1"])
def test_unipc_on_analytic_eps(sampler, steps):
    """eps(x, t) = 0.7 x + 0.3 tanh(x) cos(2 t): every step's algebra (the
    order-1 first step with its corrector, the order-2 predictor-corrector
    steps, the order-1 last step) against JAX's within 1e-5 relative. (JAX's
    f32 schedule loses ~1e-3 of sigma at t_end to cancellation; UniPC's
    readings stay at ~1.5e-6 of the port's float64 one, DPM-Solver++(2M)'s
    two- and three-step runs do not, so they are held through the trunk
    above only.)"""
    noise = _rand(6, 2, 16, 8)
    want = np.asarray(jget_ode_sampler(sampler)(
        lambda x, t: 0.7 * x + 0.3 * jnp.tanh(x) * jnp.cos(2 * t), jnp.asarray(noise),
        steps=steps))
    got = get_ode_sampler(sampler)(
        lambda x, t: 0.7 * x + 0.3 * torch.tanh(x) * np.cos(2 * t), torch.from_numpy(noise),
        steps=steps).numpy()
    assert np.abs(want - noise).max() > 0.1  # the sampler really moves x
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)


def test_unipc_refuses_what_jax_refuses():
    x = torch.zeros(1, 4, 2)
    with pytest.raises(ValueError):
        uni_pc_sample(lambda x, t: x, x, steps=1)
    with pytest.raises(NotImplementedError):
        uni_pc_sample(lambda x, t: x, x, steps=4, variant="bh3")
    with pytest.raises(NotImplementedError):
        get_ode_sampler("ddim")


def test_mel_normalisation_and_interp():
    mel = _rand(6, 1, 7, 100, scale=4.0)
    np.testing.assert_allclose(tdn.normalize_tacotron_mel(torch.from_numpy(mel)).numpy(),
                               np.asarray(jdn.normalize_tacotron_mel(jnp.asarray(mel))),
                               atol=1e-7, rtol=0)
    np.testing.assert_array_equal(tdn.nearest_interp(torch.from_numpy(mel), 30).numpy(),
                                  np.asarray(jdn._nearest_interp(jnp.asarray(mel), 30)))


def test_converter_round_trip(net):
    _, variables, port = net
    sd = porting.aa_diffusion_state_dict(variables)
    assert set(sd) == set(port.state_dict())
    back = jporting.port_aa_diffusion_state(sd, C.num_layers)
    want = jax.tree_util.tree_map(np.asarray, variables["params"])
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, want)
