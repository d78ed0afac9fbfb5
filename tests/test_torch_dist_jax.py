"""The port's data-parallel CLVP and codec GAN steps on a gloo world of 2
CPU processes against the JAX package's steps jitted on a 2-device data
mesh of the virtual CPU mesh (tests/conftest.py), over the same global
batch of 4 rows (2 per rank or device) and the same weights, with JAX's
draws injected into the port (each rank its rows of the per-row draws):

- CLVP (the global InfoNCE over the gathered latents): the mask uniforms
  injected on both sides; loss and grad norm within 1e-5 (relative), the
  parameters after the step within 1e-5 where JAX's gradient is above the
  f32 noise floor and within one learning-rate step elsewhere, as
  tests/test_torch_clvp_train.py holds one process against JAX;
- GAN from a pending codebook (the k-means init on the global pool of
  both ranks' rows, the summed EMA statistics, the dead-code replacements
  drawn from the global pool): enc_q's noise and the slice draw recorded
  from the jitted step, the quantizer's draws from its key (computed as
  tests/test_torch_quantize_train.py does); the seven losses within 1e-4
  (relative), every parameter through the porting maps as
  tests/test_torch_gan_step.py holds one process, the codebook within
  1e-5.

Both ranks end with the same parameters, bit for bit. Dropout is off on
both sides. The ranks import torch and the port only: JAX runs in the
parent.
"""

from __future__ import annotations

import functools
import pathlib

import numpy as np
import pytest
import torch

from test_torch_parallel import run_world, torch_threads, worker_main  # noqa: F401

LR = 2e-4


def _mesh():
    from ttts_tpu_torch.config import MeshConfig
    from ttts_tpu_torch.parallel import make_mesh

    return make_mesh(MeshConfig(data=2, model=1))


def _rows(x, rank: int):
    if isinstance(x, dict):
        return {k: _rows(v, rank) for k, v in x.items()}
    return x[2 * rank:2 * rank + 2]


def _no_dropout(model: torch.nn.Module) -> torch.nn.Module:
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
        if hasattr(m, "dropout") and isinstance(m.dropout, float):
            m.dropout = 0.0
    return model


def _clvp(tmp, rank, world):
    """The CLVP step of this rank's rows, JAX's mask draws injected."""
    from ttts_tpu_torch.models.clvp import CLVP
    from ttts_tpu_torch.train.state import TrainState, make_adamw
    from ttts_tpu_torch.train.steps import clvp_train_step

    case = torch.load(tmp / "clvp.pt", weights_only=False)
    port = CLVP(case["cfg"])
    port.load_state_dict(case["state_dict"])
    state = TrainState.create(_no_dropout(port), lambda ps: make_adamw(ps, 1e-3, 1))
    metrics = clvp_train_step(state, _rows(case["batch"], rank), 0,
                              draws=_rows(case["draws"], rank), mesh=_mesh())
    return {k: float(v) for k, v in metrics.items()}, port.state_dict()


def _gan(tmp, rank, world):
    """The GAN step of this rank's rows: its rows of JAX's noise and slice
    draws, the quantizer's draws of the global batch."""
    from ttts_tpu_torch.models.discriminator import MultiPeriodDiscriminator
    from ttts_tpu_torch.models.vqvae import SynthesizerTrn
    from ttts_tpu_torch.train.state import GanState, TrainState, make_gan_adam
    from ttts_tpu_torch.train.steps import vqvae_train_step

    case = torch.load(tmp / "gan.pt", weights_only=False)
    gen = SynthesizerTrn(case["cfg"].vqvae, spec_channels=case["spec_channels"],
                         segment_frames=case["seg"], for_training=True)
    gen.load_state_dict(case["g"])
    disc = MultiPeriodDiscriminator(*case["disc"])
    disc.load_state_dict(case["d"])
    opt = lambda ps: make_gan_adam(ps, LR)  # noqa: E731
    state = GanState(TrainState.create(_no_dropout(gen), opt), TrainState.create(disc, opt))
    draws = dict(_rows({k: case["draws"][k] for k in ("noise", "ids_slice")}, rank),
                 vq=case["draws"]["vq"])
    metrics = vqvae_train_step(state, _rows(case["batch"], rank), 0, case["cfg"].audio,
                               draws=draws, mesh=_mesh())
    return ({k: float(v) for k, v in metrics.items()}, gen.state_dict(), disc.state_dict(),
            [[n for n, _ in m.named_parameters()] for m in (gen, disc)])


SCENARIOS = {"clvp": _clvp, "gan": _gan}


def _jax_mesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:2]).reshape(2, 1), ("data", "model"))


def _on_mesh(mesh, states, batch):
    """The states replicated and the batch sharded over the data axis."""
    import jax
    import jax.numpy as jnp

    from ttts_tpu.parallel import replicate, shard_batch

    return ([jax.device_put(s, replicate(mesh)) for s in states],
            {k: jax.device_put(jnp.asarray(v), shard_batch(mesh, np.ndim(v)))
             for k, v in batch.items()})


def _same_on_ranks(ranks, i):
    for k, v in ranks[0][i].items():
        torch.testing.assert_close(ranks[1][i][k], v, rtol=0, atol=0)


def test_clvp_step_on_two_ranks_matches_jax_mesh(tmp_path, monkeypatch):
    import jax

    from test_torch_clvp_train import (
        CLVP_C,
        TOL,
        _clvp_batch,
        _clvp_variables,
        _jax_state,
        _torch,
        inject_draws,
    )
    from test_torch_config import to_port
    from test_torch_train_steps import GRAD_FLOOR
    from ttts_tpu.models import clvp as jclvp
    from ttts_tpu.train import state as jstate
    from ttts_tpu.train import steps as jsteps
    from ttts_tpu_torch import porting

    monkeypatch.setattr(jclvp, "EncoderLayer", functools.partial(jclvp.EncoderLayer,
                                                                 dropout=0.0))
    variables = _clvp_variables("xformers")
    b = _clvp_batch(seed=6, b=4)
    draws = inject_draws(monkeypatch, b, seed=1)
    torch.save({"cfg": to_port(CLVP_C), "state_dict": {k: torch.from_numpy(np.asarray(v))
                                                       for k, v in porting.clvp_state_dict(
                                                           variables).items()},
                "batch": _torch(b), "draws": draws}, tmp_path / "clvp.pt")
    ranks = run_world(pathlib.Path(__file__), "clvp", 2, tmp_path, timeout=120)

    model = jclvp.CLVP(CLVP_C)
    mesh = _jax_mesh()
    (state,), jb = _on_mesh(mesh, [_jax_state(variables, jstate.make_adamw(1e-3, 1))], b)
    with mesh:
        jst, want = jax.jit(functools.partial(jsteps.clvp_train_step, model=model))(
            state, jb, jax.random.key(7))
        grads = jax.jit(jax.grad(lambda p: model.apply(
            p, jb["text"], jb["speech_tokens"], return_loss=True, train=True,
            rngs={"mask": jax.random.key(0)})))(variables)
    after, grads = porting.clvp_state_dict(jst.params), porting.clvp_state_dict(grads)
    assert float(want["nonfinite_skipped"]) == 0.0
    for got, sd in ranks:
        assert got["nonfinite_skipped"] == 0.0
        for k in ("loss", "grad_norm"):
            assert abs(got[k] - float(want[k])) <= TOL * abs(float(want[k])), (k, got[k],
                                                                             float(want[k]))
        for k, v in sd.items():
            w = np.asarray(after[k]).reshape(v.shape)
            noise = np.abs(np.asarray(grads[k]).reshape(v.shape)) <= GRAD_FLOOR
            err = np.abs(v.numpy() - w)
            assert err[~noise].max(initial=0) <= TOL and err[noise].max(initial=0) <= 2e-3, k
    _same_on_ranks(ranks, 1)


def _gan_batch():
    """4 rows: two gan_inputs pairs (each a full-length row and a row 2
    frames shorter)."""
    from test_torch_vqvae_train import gan_inputs

    parts = [gan_inputs(seed=s) for s in (5, 6)]
    wav, lengths, text, tl = (np.concatenate([p[i] for p in parts]) for i in (0, 4, 5, 6))
    return {"wav": wav, "spec_lengths": lengths, "text": text, "text_lengths": tl}


def test_gan_step_on_two_ranks_matches_jax_mesh(tmp_path):
    import flax
    import jax
    import jax.numpy as jnp

    from test_api import TINY as JTINY
    from test_torch_codec_synth import _fill
    from test_torch_config import to_port
    from test_torch_gan_step import KEY_BIASES, P_CH, PERIODS, S_SPECS, STATE_TOL, TOL, Draws
    from test_torch_quantize_train import jax_vq_draws
    from test_torch_vqvae_train import (
        HOP,
        SEG,
        SPEC_CH,
        C,
        RvqKeys,
        no_style_dropout,
        training_variables,
    )
    from ttts_tpu.models import discriminator as jdisc
    from ttts_tpu.models import vqvae as jvqvae
    from ttts_tpu.train import state as jstate
    from ttts_tpu.train import steps as jsteps
    from ttts_tpu_torch import porting

    batch = _gan_batch()
    mesh = _jax_mesh()
    with pytest.MonkeyPatch.context() as mp:
        no_style_dropout(mp)
        keys, draws = RvqKeys(mp), Draws(mp)
        gen = jvqvae.SynthesizerTrn(C, spec_channels=SPEC_CH, segment_frames=SEG)
        disc = jdisc.MultiPeriodDiscriminator(periods=PERIODS, p_channels=P_CH, s_specs=S_SPECS)
        gvars = training_variables(gen, seed=1, alive=False)
        seg = jnp.zeros((1, SEG * HOP, 1))
        rng = np.random.default_rng(2)
        flat = flax.traverse_util.flatten_dict(
            jax.eval_shape(lambda: disc.init(jax.random.key(4), seg, seg))["params"])
        dparams = flax.traverse_util.unflatten_dict(
            {k: jnp.asarray(_fill(k, v.shape, rng), jnp.float32) for k, v in flat.items()})
        g = jstate.TrainState.create(apply_fn=None, params=gvars["params"],
                                     tx=jstate.make_gan_adam(LR),
                                     extra_vars={"codebook": gvars["codebook"]})
        d = jstate.TrainState.create(apply_fn=None, params=dparams, tx=jstate.make_gan_adam(LR))
        (g, d), jb = _on_mesh(mesh, [g, d], batch)
        step = jax.jit(functools.partial(jsteps.vqvae_train_step, generator=gen,
                                         discriminator=disc, audio_cfg=JTINY.audio))
        with mesh:
            g2, d2, metrics = step(g, d, jb, jax.random.key(9))
            out = jax.tree_util.tree_map(np.asarray, (g2.params, g2.extra_vars, d2.params,
                                                      metrics))
    g_params, g_extra, d_params, metrics = out
    (noise,), (u,), (vq_key,) = draws.calls["normal"], draws.calls["uniform"], keys.keys
    lengths = batch["spec_lengths"]
    ids = (u * (np.maximum(lengths - SEG, 0) + 1).astype(np.float32)).astype(np.int32)
    frames = batch["wav"].shape[1] // HOP
    torch.save({"cfg": to_port(JTINY), "spec_channels": SPEC_CH, "seg": SEG,
                "disc": (PERIODS, P_CH, S_SPECS),
                "g": {k: torch.from_numpy(np.asarray(v)) for k, v in
                      porting.synthesizer_trn_state_dict(gvars, for_training=True).items()},
                "d": {k: torch.from_numpy(np.asarray(v)) for k, v in
                      porting.discriminator_state_dict({"params": dparams}).items()},
                "batch": {k: torch.as_tensor(v).long() if v.dtype.kind in "iu"
                          else torch.as_tensor(v) for k, v in batch.items()},
                "draws": {"noise": torch.tensor(noise), "ids_slice": torch.tensor(ids).long(),
                          "vq": jax_vq_draws(vq_key, 4 * (frames // 2), C.n_q,
                                             C.codebook_bins, C.kmeans_seeding)}},
               tmp_path / "gan.pt")
    ranks = run_world(pathlib.Path(__file__), "gan", 2, tmp_path, timeout=150)

    want_g = porting.synthesizer_trn_state_dict({"params": g_params, **g_extra},
                                                for_training=True)
    want_d = porting.discriminator_state_dict({"params": d_params})
    for got_m, got_g, got_d, names in ranks:
        assert got_m.keys() == metrics.keys()
        for k, v in metrics.items():
            assert abs(got_m[k] - float(v)) <= TOL * abs(float(v)), (k, got_m[k], float(v))
        for got, want, params in zip((got_g, got_d), (want_g, want_d), names):
            for n in params:
                v, w = got[n], want[n].astype(np.float64)
                err = np.linalg.norm(v.numpy().astype(np.float64) - w)
                bound = (2 * LR * np.sqrt(w.size) if n.endswith(KEY_BIASES)
                         else TOL * np.linalg.norm(w))
                assert err <= bound, (n, err, bound)
        assert float(got_g["quantizer.vq.layers.0._codebook.inited"][0]) == 1.0
        for k in ("embed", "embed_avg", "cluster_size"):
            n = f"quantizer.vq.layers.0._codebook.{k}"
            np.testing.assert_allclose(got_g[n].numpy(), want_g[n], rtol=STATE_TOL,
                                       atol=STATE_TOL, err_msg=n)
    _same_on_ranks(ranks, 1)
    _same_on_ranks(ranks, 2)


if __name__ == "__main__":
    worker_main(SCENARIOS)
