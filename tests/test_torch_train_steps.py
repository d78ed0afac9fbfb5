"""PyTorch port parity of the training path (ttts_tpu_torch against
ttts_tpu) on the CPU, in f32, at TINY widths:

- the GPT's training forward: text and mel cross-entropy within 1e-5, and
  the gradients, carried into the port's layout by the porting map (a pure
  relayout), within 1e-4 relative (L2) per tensor, plus 1e-6 absolute (L2)
  for gradients that are zero analytically (an attention key bias, which
  the softmax cancels, is f32 noise on both sides), in train mode (SDPA)
  and in eval mode (through attention.attend's plain version);
- diffusion/gaussian.py: the schedules and q / posterior tables, the
  training losses on injected t and noise, p_sample_loop and
  ddim_sample_loop with JAX's noise injected (1e-5);
- AA_diffusion in train mode with JAX's unconditioned rows and layer-drop
  choices injected: output within 1e-4, gradients within 1e-4 relative per
  tensor;
- one whole diffusion_train_step with JAX's draws of t, noise, the
  unconditioned rows and the layer choices recorded and injected: loss,
  MSE, VLB and the global grad norm within 1e-4 relative;
- the timestep samplers of diffusion/resample.py;
- dropout: active in train mode, inactive in eval mode.

Dropout masks cannot match JAX's, so the parity cases run with dropout 0.
Weights: jax.eval_shape of each init filled from a numpy seed
(test_torch_codec_synth.seeded_variables)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_api import TINY as JTINY
from test_torch_codec_synth import rel, seeded_variables
from test_torch_config import to_port
from ttts_tpu.diffusion import gaussian as jg
from ttts_tpu.diffusion import resample as jres
from ttts_tpu.models import diffusion_net as jdn
from ttts_tpu.models import gpt as jgpt
from ttts_tpu.train import state as jstate
from ttts_tpu.train import steps as jsteps
from ttts_tpu_torch import porting
from ttts_tpu_torch.diffusion import gaussian as tg
from ttts_tpu_torch.diffusion import resample as tres
from ttts_tpu_torch.models import diffusion_net as tdn
from ttts_tpu_torch.models.gpt import UnifiedVoice
from ttts_tpu_torch.train import state as tstate
from ttts_tpu_torch.train import steps as tsteps

GPT_C = dataclasses.replace(JTINY.gpt, dropout=0.0)
NET_C = dataclasses.replace(JTINY.diffusion_net, layer_drop=0.5)
GRAD_TOL, GRAD_FLOOR = 1e-4, 1e-6


def _gpt_batch(seed=0, b=3, lt=12, lm=20):
    rng = np.random.default_rng(seed)
    text = rng.integers(1, 200, (b, lt)).astype(np.int32)
    text[0, 9:] = 0  # text padding (0 == stop_text_token)
    codes = rng.integers(0, 1024, (b, lm)).astype(np.int32)
    wav = np.asarray([lm * 1024, 11 * 1024, 16 * 1024], np.int32)[:b]
    return {"text": text, "text_lengths": np.asarray([9, lt, lt], np.int32)[:b],
            "mel_codes": codes, "wav_lengths": wav}


def _torch(batch):
    return {k: torch.as_tensor(v).long() if v.dtype.kind in "iu" else torch.as_tensor(v)
            for k, v in batch.items()}


def _port(module, state_dict):
    module.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in state_dict.items()})
    return module


def _grads_close(names, grads, want_sd, skip_zero=False):
    for n, g in zip(names, grads):
        want = want_sd[n]
        if g is None:
            assert not np.any(want), n
            continue
        if skip_zero and not np.any(want):
            assert not g.abs().max() > 0, n
            continue
        err = np.linalg.norm(g.detach().numpy().astype(np.float64) - want)
        assert err <= GRAD_TOL * np.linalg.norm(want) + GRAD_FLOOR, (n, err, np.linalg.norm(want))


@pytest.fixture(scope="module")
def gpt():
    model = jgpt.UnifiedVoice(GPT_C)
    b = _gpt_batch()
    variables = seeded_variables(lambda: model.init(
        jax.random.key(0), *(jnp.asarray(b[k]) for k in
                             ("text", "text_lengths", "mel_codes", "wav_lengths"))))
    port = _port(UnifiedVoice(to_port(GPT_C)), porting.unified_voice_state_dict(variables))
    return model, variables, port


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_gpt_losses_and_grads(gpt, mode):
    model, variables, port = gpt
    b = _gpt_batch()
    args = [jnp.asarray(b[k]) for k in ("text", "text_lengths", "mel_codes", "wav_lengths")]

    def loss_fn(v):
        lt, lm, _ = model.apply(v, *args, deterministic=False,
                                rngs={"dropout": jax.random.key(1)})
        return 0.01 * lt + lm, (lt, lm)

    (_, (jlt, jlm)), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(variables)
    port.train(mode == "train")
    loss, lt, lm = tsteps.gpt_loss(port, _torch(b))
    assert abs(lt.item() - float(jlt)) <= 1e-5 * abs(float(jlt))
    assert abs(lm.item() - float(jlm)) <= 1e-5 * abs(float(jlm))
    names, params = zip(*port.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    _grads_close(names, grads, porting.unified_voice_state_dict(jgrads))


def test_gpt_dropout_active_only_in_train_mode():
    port = UnifiedVoice(to_port(dataclasses.replace(JTINY.gpt, dropout=0.3)))
    b = _torch(_gpt_batch())
    port.eval()
    with torch.no_grad():
        a, c = (tsteps.gpt_loss(port, b)[0] for _ in range(2))
    assert float(a) == float(c)
    port.train()
    with torch.no_grad():
        d, e = (tsteps.gpt_loss(port, b)[0] for _ in range(2))
    assert float(d) != float(e) and float(d) != float(a)


# ---------------------------------------------------------------- gaussian


@pytest.mark.parametrize("name", ["linear", "cosine"])
def test_schedules_and_tables(name):
    betas = tg.get_named_beta_schedule(name, 40)
    np.testing.assert_array_equal(betas, jg.get_named_beta_schedule(name, 40))
    j, t = jg.GaussianDiffusion(betas=betas), tg.GaussianDiffusion(betas=betas)
    for k in ("alphas_cumprod", "posterior_variance", "posterior_log_variance_clipped",
              "posterior_mean_coef1", "posterior_mean_coef2", "sqrt_recipm1_alphas_cumprod"):
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k))
    rng = np.random.default_rng(0)
    x0, xt, noise = (rng.standard_normal((3, 8, 4)).astype(np.float32) for _ in range(3))
    ts = np.asarray([0, 17, 39])
    np.testing.assert_allclose(
        t.q_sample(torch.tensor(x0), torch.tensor(ts), torch.tensor(noise)).numpy(),
        np.asarray(j.q_sample(jnp.asarray(x0), jnp.asarray(ts), jnp.asarray(noise))),
        atol=1e-6)
    for a, b in zip(t.q_posterior_mean_variance(torch.tensor(x0), torch.tensor(xt),
                                                torch.tensor(ts)),
                    j.q_posterior_mean_variance(jnp.asarray(x0), jnp.asarray(xt),
                                                jnp.asarray(ts))):
        np.testing.assert_allclose(a.numpy(), np.broadcast_to(np.asarray(b), a.shape),
                                   atol=1e-6)


def _affine_model(lib):
    """A fixed model (B, T, C) → (B, T, 2C): eps and the variance fraction
    as smooth functions of x and t, the same in both libraries."""
    w = np.random.default_rng(7).standard_normal((4, 8)).astype(np.float32) * 0.3

    def fn(x, t, conditioning_free=False):
        tt = (t.float() if lib is torch else t.astype(jnp.float32)) / 40.0
        ww = torch.tensor(w) if lib is torch else jnp.asarray(w)
        out = lib.tanh(x @ ww + tt[:, None, None])
        return out * (0.5 if conditioning_free else 1.0)

    return fn


def test_training_losses_with_injected_noise():
    betas = jg.get_named_beta_schedule("linear", 40)
    j, t = jg.GaussianDiffusion(betas=betas), tg.GaussianDiffusion(betas=betas)
    rng = np.random.default_rng(1)
    x0 = rng.uniform(-1, 1, (4, 8, 4)).astype(np.float32)
    ts = np.asarray([0, 3, 20, 39])
    key = jax.random.key(2)
    noise = np.asarray(jax.random.normal(key, x0.shape, jnp.float32))
    want = j.training_losses(_affine_model(jnp), jnp.asarray(x0), jnp.asarray(ts), key)
    got = t.training_losses(_affine_model(torch), torch.tensor(x0), torch.tensor(ts),
                            torch.tensor(noise))
    for k in ("loss", "mse", "vb", "x_t"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-6)


def _jax_loop_noise(key, shape, n):
    """The start and per-step noise JAX's loops draw from `key`."""
    key, nk = jax.random.split(key)
    steps = jax.random.split(key, n)
    return np.stack([np.asarray(jax.random.normal(nk, shape))]
                    + [np.asarray(jax.random.normal(k, shape)) for k in steps])


@pytest.mark.parametrize("loop", ["p_sample_loop", "ddim_sample_loop"])
def test_sampling_loops_with_injected_noise(loop):
    base = jg.get_named_beta_schedule("linear", 40)
    use = jg.space_timesteps(40, [10])
    assert use == tg.space_timesteps(40, [10]) and jg.space_timesteps(40, "ddim8") == \
        tg.space_timesteps(40, "ddim8")
    kw = dict(conditioning_free=True, conditioning_free_k=1.5)
    j = jg.SpacedDiffusion(use, base, **kw)
    t = tg.SpacedDiffusion(use, base, **kw)
    assert t.timestep_map == j.timestep_map
    shape, key = (2, 8, 4), jax.random.key(4)
    want = getattr(j, loop)(_affine_model(jnp), shape, key)
    noise = torch.tensor(_jax_loop_noise(key, shape, t.num_timesteps))
    got = getattr(t, loop)(_affine_model(torch), shape, noise=noise)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------- AA_diffusion train


@pytest.fixture(scope="module")
def net():
    model = jdn.AA_diffusion(NET_C)
    mel = jnp.zeros((1, 32, NET_C.in_channels))
    variables = seeded_variables(lambda: model.init(
        jax.random.key(0), mel, jnp.asarray([1.0]), jnp.zeros((1, 16, NET_C.in_latent_channels)),
        mel))
    port = _port(tdn.AA_diffusion(to_port(NET_C)), porting.aa_diffusion_state_dict(variables))
    return model, variables, port


class Recorder:
    """Records what jax.random.{randint, normal, uniform, bernoulli} return
    while JAX runs, to inject the same draws into the port."""

    def __init__(self, monkeypatch):
        self.calls = {}
        for name in ("randint", "normal", "uniform", "bernoulli"):
            fn = getattr(jax.random, name)
            monkeypatch.setattr(jax.random, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        def f(*a, **k):
            out = fn(*a, **k)
            self.calls.setdefault(name, []).append(np.asarray(out))
            return out
        return f

    def draws(self, layers: int, net_cfg):
        """The port's draws: t, noise, the unconditioned rows and the layer
        choices (layers 0 < i < n-1 draw a bernoulli each, in order)."""
        keep = [True] * layers
        eligible = [i for i in range(1, layers - 1)] if net_cfg.layer_drop > 0 else []
        for i, k in zip(eligible, self.calls.get("bernoulli", [])):
            keep[i] = bool(k)
        out = {"layer_keep": keep,
               "uncond": torch.tensor(self.calls["uniform"][0].reshape(-1) < 0.5)}
        if "randint" in self.calls:
            out["t"] = torch.tensor(self.calls["randint"][0]).long()
        if "normal" in self.calls:
            out["noise"] = torch.tensor(self.calls["normal"][0])
        return out


def _net_inputs(seed=3, b=3, t=32, tl=12, tr=20):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, NET_C.in_channels)).astype(np.float32),
            np.asarray([5.0, 300.0, 900.0][:b], np.float32),
            rng.standard_normal((b, tl, NET_C.in_latent_channels)).astype(np.float32),
            rng.standard_normal((b, tr, NET_C.in_channels)).astype(np.float32))


def test_aa_diffusion_train_mode_with_injected_masks(net, monkeypatch):
    model, variables, port = net
    x, ts, latent, refer = _net_inputs()
    rec = Recorder(monkeypatch)
    keys = {"uncond": jax.random.key(11), "layerdrop": jax.random.key(12),
            "dropout": jax.random.key(13)}

    def fwd(v):
        out = model.apply(v, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(latent),
                          jnp.asarray(refer), train=True, unconditioned_percentage=0.5,
                          rngs=keys)
        return jnp.sum(out * jnp.cos(out)), out

    (_, want), jgrads = jax.value_and_grad(fwd, has_aux=True)(variables)
    draws = rec.draws(len(port.layers), NET_C)
    port.train()
    out = port(torch.tensor(x), torch.tensor(ts), torch.tensor(latent), torch.tensor(refer),
               uncond=draws["uncond"], layer_keep=draws["layer_keep"])
    assert rel(out.detach().numpy(), np.asarray(want)) <= 1e-4
    names, params = zip(*port.named_parameters())
    grads = torch.autograd.grad(torch.sum(out * torch.cos(out)), params, allow_unused=True)
    _grads_close(names, grads, porting.aa_diffusion_state_dict(jgrads), skip_zero=True)


def test_resblock_dropout_active_only_in_train_mode():
    blk = tdn.ScaleShiftResBlock(64, 64, dropout=0.3)
    x, emb = torch.randn(2, 8, 64), torch.randn(2, 64)
    blk.eval()
    with torch.no_grad():
        assert torch.equal(blk(x, emb), blk(x, emb))
        a = blk(x, emb)
        blk.train()
        b, c = blk(x, emb), blk(x, emb)
    assert not torch.equal(b, c) and not torch.equal(a, b)


def test_diffusion_train_step_with_jax_draws(gpt, net, monkeypatch):
    gmodel, gvars, gport = gpt
    model, variables, port = net
    rng = np.random.default_rng(5)
    b = _gpt_batch(seed=6)
    mel = rng.standard_normal((3, 32, NET_C.in_channels)).astype(np.float32) - 2.0
    refer = rng.standard_normal((3, 24, NET_C.in_channels)).astype(np.float32) - 2.0
    batch = dict(b, mel=mel, mel_refer=refer)
    betas = jg.get_named_beta_schedule("linear", 50)
    diffuser = jg.GaussianDiffusion(betas=betas)
    jst = jstate.TrainState.create(apply_fn=None, params=variables,
                                   tx=jstate.make_adamw(1e-3, 10))
    rec = Recorder(monkeypatch)
    _, want = jsteps.diffusion_train_step(jst, {k: jnp.asarray(v) for k, v in batch.items()},
                                          jax.random.key(21), model, diffuser, gmodel, gvars,
                                          unconditioned_percentage=0.5)
    draws = rec.draws(len(port.layers), NET_C)
    port_net = _port(tdn.AA_diffusion(to_port(NET_C)), porting.aa_diffusion_state_dict(variables))
    tst = tstate.TrainState.create(port_net, lambda ps: tstate.make_adamw(ps, 1e-3, 10))
    got = tsteps.diffusion_train_step(tst, _torch(batch), 0, tg.GaussianDiffusion(betas=betas),
                                      gport.eval(), unconditioned_percentage=0.5, draws=draws)
    for k in ("loss", "mse", "vb", "grad_norm"):
        assert abs(float(got[k]) - float(want[k])) <= 1e-4 * abs(float(want[k])), k
    assert got["nonfinite_skipped"] == float(want["nonfinite_skipped"]) == 0.0
    assert tst.step == 1


def test_diffusion_draws_follow_the_key():
    a, b = (tsteps.diffusion_draws(9, (4, 16, 100), 1000, 9, 0.1, 0.1, torch.device("cpu"))
            for _ in range(2))
    c = tsteps.diffusion_draws(10, (4, 16, 100), 1000, 9, 0.1, 0.1, torch.device("cpu"))
    assert all(torch.equal(a[k], b[k]) for k in ("t", "noise", "uncond"))
    assert a["layer_keep"] == b["layer_keep"] and not torch.equal(a["noise"], c["noise"])
    assert a["t"].min() >= 0 and a["t"].max() < 1000 and len(a["layer_keep"]) == 9


# --------------------------------------------------------------- resample


def test_schedule_samplers():
    n = 20
    for name in ("uniform", "deterministic", "loss-second-moment"):
        assert type(tres.create_named_schedule_sampler(name, n)).__name__ == type(
            jres.create_named_schedule_sampler(name, n)).__name__
    t, w = tres.UniformSampler(n).sample(torch.Generator().manual_seed(0), 64)
    assert t.min() >= 0 and t.max() < n and torch.equal(w, torch.ones(64))
    jd, td = jres.DeterministicSampler(n), tres.DeterministicSampler(n)
    for _ in range(3):
        np.testing.assert_array_equal(td.sample(None, 7)[0].numpy(),
                                      np.asarray(jd.sample(None, 7)[0]))
    jl, tl = jres.LossSecondMomentResampler(n), tres.LossSecondMomentResampler(n)
    rng = np.random.default_rng(0)
    for _ in range(30):
        ts, losses = rng.integers(0, n, 16), rng.uniform(0.1, 2.0, 16)
        jl.update_with_losses(ts, losses)
        tl.update_with_losses(ts, losses)
        np.testing.assert_array_equal(tl.weights(), jl.weights())
    assert tl._warmed_up()
    t, w = tl.sample(torch.Generator().manual_seed(0), 4096)
    p = torch.as_tensor(tl.weights(), dtype=torch.float32)
    np.testing.assert_allclose(w.numpy(), (1.0 / (n * p[t])).numpy())
    freq = np.bincount(t.numpy(), minlength=n) / 4096
    assert np.abs(freq - tl.weights()).max() < 0.05
