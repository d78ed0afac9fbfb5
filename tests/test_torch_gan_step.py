"""One whole codec GAN step of the port (ttts_tpu_torch.train.steps.
vqvae_train_step) against the JAX package's (ttts_tpu.train.steps.
vqvae_train_step, jitted once for the module) on the CPU, in f32, at TINY
widths with a small MultiPeriodDiscriminator (periods 2 and 3, narrow
channels), augment_cfg None and a codebook already initialised whose
cluster sizes keep every code alive, so that JAX's quantizer draws play no
part. enc_q's noise and the slice draw are recorded from jax.random.normal
and jax.random.uniform while the jitted step runs (debug callbacks) and
injected.

- the seven losses within 1e-4 relative;
- the gradients each optimizer receives (recorded on both sides: a debug
  callback in the optax update, a wrapper around the port's AdamW.update),
  through the porting maps, within 1e-4 relative (L2) per tensor plus 1e-6
  of the global norm, as test_torch_vqvae_train holds the forward's; the
  same exception for the first stage of enc_q's raw-audio path (3e-3, JAX's
  compiled f32 gradients there are off their f64 value), measured there.
  Adam's first step is lr * sign(g) to within eps, so the updated
  parameters alone would not see a gradient of the wrong size;
- every updated generator and discriminator parameter (through the porting
  maps) within 1e-4 relative (L2) per tensor, but for the attention key
  biases: their gradients are zero analytically (f32 noise on both sides),
  so Adam's first step moves each element by up to lr in either direction
  on either side, and they are held to 2 lr per element (L2) of JAX's;
- the updated codebook state within 1e-5;
- D gathers no gradient from the G loss, and a step with the EQ and the
  device warp on runs with every nearest-code search detached.

Dropout masks cannot match JAX's: both sides run with dropout 0."""

import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_api import TINY as JTINY
from test_torch_codec_synth import _fill
from test_torch_config import TINY
from test_torch_vqvae_train import (
    GRAD_FLOOR,
    GRAD_TOL,
    STAGE0,
    STAGE0_JAX_TOL,
    C,
    HOP,
    SEG,
    gan_inputs,
    no_style_dropout,
    port_generator,
    torch_threads,  # noqa: F401 (autouse)
    training_variables,
)
from ttts_tpu.models import discriminator as jdisc
from ttts_tpu.models import vqvae as jvqvae
from ttts_tpu.train import state as jstate
from ttts_tpu.train import steps as jsteps
from ttts_tpu_torch import porting
from ttts_tpu_torch.models.discriminator import MultiPeriodDiscriminator
from ttts_tpu_torch.models.quantize import vq_draws
from ttts_tpu_torch.ops.cuda import vq
from ttts_tpu_torch.train import mains
from ttts_tpu_torch.train.state import GanState, TrainState, make_gan_adam
from ttts_tpu_torch.train.steps import vqvae_train_step

PERIODS, P_CH = (2, 3), (8, 16, 32, 32)
S_SPECS = ((8, 15, 1, 1), (16, 41, 4, 4), (32, 41, 4, 16), (32, 5, 1, 1))
LR, TOL, STATE_TOL = 2e-4, 1e-4, 1e-5
KEY_BIASES = ("conv_k.bias", "w_ks.bias")


class Draws:
    """Records what jax.random.normal / uniform return while a jitted
    function runs (debug callbacks)."""

    def __init__(self, monkeypatch):
        self.calls = {"normal": [], "uniform": []}
        for name in self.calls:
            monkeypatch.setattr(jax.random, name, self._wrap(name, getattr(jax.random, name)))

    def _wrap(self, name, fn):
        def f(*a, **k):
            out = fn(*a, **k)
            jax.debug.callback(lambda v: self.calls[name].append(np.asarray(v)), out)
            return out
        return f


def _recording(tx, sink):
    """tx, with the gradients each update receives appended to `sink` (a
    debug callback, so it records inside the jitted step)."""
    def update(grads, state, params=None):
        jax.debug.callback(lambda g: sink.append(jax.tree_util.tree_map(np.asarray, g)), grads)
        return tx.update(grads, state, params)

    return optax.GradientTransformation(tx.init, update)


def _batch():
    wav, _, _, _, lengths, text, tl = gan_inputs(seed=5)
    return {"wav": wav, "spec_lengths": lengths, "text": text, "text_lengths": tl}


@pytest.fixture(scope="module")
def jax_step():
    with pytest.MonkeyPatch.context() as mp:
        no_style_dropout(mp)
        gen = jvqvae.SynthesizerTrn(C, spec_channels=JTINY.audio.filter_length // 2 + 1,
                                    segment_frames=SEG)
        disc = jdisc.MultiPeriodDiscriminator(periods=PERIODS, p_channels=P_CH, s_specs=S_SPECS)
        gvars = training_variables(gen, seed=1)
        seg = jnp.zeros((1, SEG * HOP, 1))
        rng = np.random.default_rng(2)
        flat = flax.traverse_util.flatten_dict(
            jax.eval_shape(lambda: disc.init(jax.random.key(4), seg, seg))["params"])
        dparams = flax.traverse_util.unflatten_dict(
            {k: jnp.asarray(_fill(k, v.shape, rng), jnp.float32) for k, v in flat.items()})
        grads = {"g": [], "d": []}
        g = jstate.TrainState.create(apply_fn=None, params=gvars["params"],
                                     tx=_recording(jstate.make_gan_adam(LR), grads["g"]),
                                     extra_vars={"codebook": gvars["codebook"]})
        d = jstate.TrainState.create(apply_fn=None, params=dparams,
                                     tx=_recording(jstate.make_gan_adam(LR), grads["d"]))
        draws = Draws(mp)
        step = jax.jit(functools.partial(jsteps.vqvae_train_step, generator=gen,
                                         discriminator=disc, audio_cfg=JTINY.audio))
        batch = _batch()
        g2, d2, metrics = step(g, d, {k: jnp.asarray(v) for k, v in batch.items()},
                               jax.random.key(9))
        out = jax.tree_util.tree_map(np.asarray, (g2.params, g2.extra_vars, d2.params, metrics))
    assert len(grads["g"]) == len(grads["d"]) == 1
    return gvars, {"params": dparams}, batch, draws.calls, out, grads


def _port_state(gvars, dvars) -> GanState:
    gen = port_generator(gvars)
    disc = MultiPeriodDiscriminator(PERIODS, P_CH, S_SPECS)
    disc.load_state_dict({k: torch.from_numpy(v)
                          for k, v in porting.discriminator_state_dict(dvars).items()})
    opt = lambda ps: make_gan_adam(ps, LR)  # noqa: E731
    return GanState(TrainState.create(gen, opt), TrainState.create(disc, opt))


def _torch(batch):
    return {k: torch.as_tensor(v).long() if v.dtype.kind in "iu" else torch.as_tensor(v)
            for k, v in batch.items()}


def _held(got_sd, want_sd, names):
    for n in names:
        got, want = got_sd[n].numpy().astype(np.float64), want_sd[n].astype(np.float64)
        err = np.linalg.norm(got - want)
        if n.endswith(KEY_BIASES):
            assert err <= 2 * LR * np.sqrt(want.size), (n, err)
        else:
            assert err <= TOL * np.linalg.norm(want), (n, err, np.linalg.norm(want))


def _recorded(opt, sink):
    """Wraps opt.update so that the gradients it receives land in `sink`."""
    real = opt.update

    def update(grads, norm=None):
        sink.extend(None if g is None else g.detach().clone() for g in grads)
        return real(grads, norm)

    opt.update = update


def _grads_held(names, got, want_sd, tol_of=lambda n: GRAD_TOL):
    want = [want_sd[n].astype(np.float64) for n in names]
    floor = GRAD_FLOOR * np.sqrt(sum(float(np.sum(w ** 2)) for w in want))
    assert len(got) == len(names)
    for n, g, w in zip(names, got, want):
        g = np.zeros_like(w) if g is None else g.numpy().astype(np.float64)
        err = np.linalg.norm(g - w)
        assert err <= tol_of(n) * np.linalg.norm(w) + floor, (n, err, np.linalg.norm(w))


def test_gan_step_matches_jax(jax_step):
    gvars, dvars, batch, calls, (g_params, g_extra, d_params, metrics), jgrads = jax_step
    (noise,), (u,) = calls["normal"], calls["uniform"]
    lengths = batch["spec_lengths"]
    ids = (u * (np.maximum(lengths - SEG, 0) + 1).astype(np.float32)).astype(np.int32)
    state = _port_state(gvars, dvars)
    draws = {"noise": torch.tensor(noise), "ids_slice": torch.tensor(ids).long(),
             "vq": vq_draws(2 * 4, C.n_q, C.codebook_bins, C.kmeans_seeding,
                            torch.Generator().manual_seed(0))}
    seen = {"g": [], "d": []}
    _recorded(state.g.opt, seen["g"])
    _recorded(state.d.opt, seen["d"])
    got = vqvae_train_step(state, _torch(batch), 0, TINY.audio, draws=draws)
    assert got.keys() == metrics.keys()
    g_names = [n for n, _ in state.g.model.named_parameters()]
    _grads_held(g_names, seen["g"], porting.synthesizer_trn_state_dict(
        {"params": jgrads["g"][0], **g_extra}, for_training=True),
        lambda n: STAGE0_JAX_TOL if n.startswith(STAGE0) else GRAD_TOL)
    _grads_held([n for n, _ in state.d.model.named_parameters()], seen["d"],
                porting.discriminator_state_dict({"params": jgrads["d"][0]}))
    for k, v in metrics.items():
        assert abs(float(got[k]) - float(v)) <= TOL * abs(float(v)), (k, float(got[k]), float(v))
    assert state.g.step == state.d.step == 1
    want_g = porting.synthesizer_trn_state_dict({"params": g_params, **g_extra}, for_training=True)
    got_g = state.g.model.state_dict()
    _held(got_g, want_g, [n for n, _ in state.g.model.named_parameters()])
    for k in ("embed", "embed_avg", "cluster_size"):
        n = f"quantizer.vq.layers.0._codebook.{k}"
        np.testing.assert_allclose(got_g[n].numpy(), want_g[n], rtol=STATE_TOL, atol=STATE_TOL)
    want_d = porting.discriminator_state_dict({"params": d_params})
    _held(state.d.model.state_dict(), want_d, [n for n, _ in state.d.model.named_parameters()])


def test_d_gathers_no_gradient_from_the_g_loss(jax_step):
    """After the step no D parameter holds a .grad (the G loss's gradients
    are taken for G's parameters alone, and the optimizer clears its own)."""
    gvars, dvars, batch = jax_step[:3]
    state = _port_state(gvars, dvars)
    vqvae_train_step(state, _torch(batch), 3, TINY.audio)
    assert all(p.grad is None for p in state.d.model.parameters())
    assert all(p.grad is None for p in state.g.model.parameters())


def test_augmented_step_searches_detached(jax_step, monkeypatch):
    """With the EQ and the device warp on (their draws from the key), a
    step's nearest-code searches get no input that requires grad, with grad
    mode off, on a pending codebook (the k-means init's pass, then the
    search) and on the next step; every loss is finite."""
    gvars, dvars, batch = jax_step[:3]
    seen = []
    real = vq.nearest

    def spy(x, cb):
        seen.append(x.requires_grad or cb.requires_grad or torch.is_grad_enabled())
        return real(x, cb)

    monkeypatch.setattr(vq, "nearest", spy)
    state = _port_state(gvars, dvars)
    cb = state.g.model.quantizer.state()
    cb.inited = torch.tensor(False)
    state.g.model.quantizer.set_state(cb)
    aug = mains.make_vqvae_augment_cfg(TINY)
    for key in (1, 2):
        m = vqvae_train_step(state, _torch(batch), key, TINY.audio, augment_cfg=aug,
                             device_warp=True)
        assert all(np.isfinite(float(v)) for v in m.values())
    assert len(seen) == 3 and not any(seen)


def test_vqvae_draws_follow_the_key():
    """The step's draws repeat for a key and change with it: the noise of
    the batch's frames, slice starts within each row's valid frames, the
    quantizer's rows of B * T/2, the EQ's and the warp's parameters."""
    from ttts_tpu_torch.train.steps import vqvae_draws

    gen = port_generator(training_variables(
        jvqvae.SynthesizerTrn(C, spec_channels=JTINY.audio.filter_length // 2 + 1,
                              segment_frames=SEG)))
    batch = _torch(_batch())
    aug = mains.make_vqvae_augment_cfg(TINY)
    a, b, c = (vqvae_draws(k, batch, gen, HOP, aug, True) for k in (5, 5, 6))
    assert torch.equal(a["noise"], b["noise"]) and not torch.equal(a["noise"], c["noise"])
    assert a["noise"].shape == (2, 8, C.inter_channels)
    assert torch.equal(a["ids_slice"], b["ids_slice"])
    assert (a["ids_slice"] >= 0).all() and (a["ids_slice"] <= batch["spec_lengths"] - SEG).all()
    assert all(torch.equal(x, y) for x, y in zip(a["vq"]["replace"], b["vq"]["replace"]))
    assert a["vq"]["replace"][0].max() < 2 * 4 and a["vq"]["replace"][0].numel() == C.codebook_bins
    for k in ("quality_power", "gain"):
        assert torch.equal(a["peq"][k], b["peq"][k]) and a["peq"][k].shape == (2, 10)
    assert set(a["warp"]) == {"formant_shift", "pitch_shift"}
    assert "warp" not in vqvae_draws(5, batch, gen, HOP, aug, False)
