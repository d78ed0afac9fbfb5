"""PyTorch port parity of the codec GAN's pieces (ttts_tpu_torch against
ttts_tpu) on the CPU, in f32:

- the five losses (feature matching with the real features detached,
  LSGAN discriminator and generator, KL, MLE) within 1e-6;
- MultiPeriodDiscriminator scores and feature maps, carried through
  porting.discriminator_state_dict, within 1e-5 relative (L2), at the
  reference's widths with the JAX test's periods (2, 3) and at narrow widths
  with every period (2, 3, 5, 7, 11) (a length no period divides: the
  reflect pad); its gradients within 1e-4; discriminator_variables inverts
  the map exactly;
- make_gan_adam against optax over 5 steps of random gradients (1e-6);
- vits_mel_spectrogram, the GAN's 128-mel loss mel, within 1e-5.
Weights: jax.eval_shape of each init filled from a numpy seed."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_codec_synth import rel, seeded_variables
from test_torch_vqvae_train import torch_threads  # noqa: F401 (autouse)
from ttts_tpu.models import discriminator as jdisc
from ttts_tpu.models import losses as jl
from ttts_tpu.ops import mel as jmel
from ttts_tpu.train import state as jstate
from ttts_tpu_torch import porting
from ttts_tpu_torch.models import discriminator as tdisc
from ttts_tpu_torch.models import losses as tl
from ttts_tpu_torch.ops import mel as tmel
from ttts_tpu_torch.train import state as tstate

NARROW = dict(p_channels=(8, 16, 32, 32),
              s_specs=((8, 15, 1, 1), (16, 41, 4, 4), (32, 41, 4, 16), (32, 41, 4, 16),
                       (32, 5, 1, 1)))


def _nested(rng, shapes):
    return [[rng.standard_normal(s).astype(np.float32) for s in group] for group in shapes]


def test_losses():
    rng = np.random.default_rng(0)
    fr = _nested(rng, [[(2, 5, 3), (2, 7)], [(2, 4, 4)]])
    fg = _nested(rng, [[(2, 5, 3), (2, 7)], [(2, 4, 4)]])
    dr = [rng.standard_normal((2, 9)).astype(np.float32) for _ in range(3)]
    dg = [rng.standard_normal((2, 9)).astype(np.float32) for _ in range(3)]
    t = lambda xs: [torch.tensor(x) for x in xs]  # noqa: E731
    j = lambda xs: [jnp.asarray(x) for x in xs]  # noqa: E731
    close = lambda a, b: np.testing.assert_allclose(np.asarray(a), np.asarray(b),  # noqa: E731
                                                    rtol=1e-6, atol=1e-6)
    close(tl.feature_loss([t(g) for g in fr], [t(g) for g in fg]),
          jl.feature_loss([j(g) for g in fr], [j(g) for g in fg]))
    got, want = tl.discriminator_loss(t(dr), t(dg)), jl.discriminator_loss(j(dr), j(dg))
    close(got[0], want[0])
    for a, b in zip(got[1] + got[2], want[1] + want[2]):
        close(a, b)
    got, want = tl.generator_loss(t(dg)), jl.generator_loss(j(dg))
    close(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        close(a, b)
    z_p, logs_q, m_p, logs_p, z = (rng.standard_normal((2, 6, 4)).astype(np.float32)
                                   for _ in range(5))
    mask = np.ones((2, 6, 1), np.float32)
    mask[1, 4:] = 0
    close(tl.kl_loss(*t([z_p, logs_q, m_p, logs_p, mask])),
          jl.kl_loss(*j([z_p, logs_q, m_p, logs_p, mask])))
    logdet = rng.standard_normal(2).astype(np.float32)
    close(tl.mle_loss(*t([z, m_p, logs_p, logdet, mask])),
          jl.mle_loss(*j([z, m_p, logs_p, logdet, mask])))


def test_feature_loss_detaches_the_real_features():
    fr = [[torch.randn(2, 3, requires_grad=True)]]
    fg = [[torch.randn(2, 3, requires_grad=True)]]
    tl.feature_loss(fr, fg).backward()
    assert fr[0][0].grad is None and fg[0][0].grad is not None


@pytest.mark.parametrize("periods,narrow,t", [((2, 3), False, 1280),
                                              ((2, 3, 5, 7, 11), True, 1283)])
def test_mpd_scores_fmaps_and_grads(periods, narrow, t):
    kw = NARROW if narrow else {}
    jmod = jdisc.MultiPeriodDiscriminator(periods=periods, **kw)
    rng = np.random.default_rng(t)
    y, y_hat = (0.3 * rng.standard_normal((2, t, 1)).astype(np.float32) for _ in range(2))
    variables = seeded_variables(lambda: jmod.init(jax.random.key(0), y, y_hat), seed=t)
    sd = porting.discriminator_state_dict(variables)
    port = tdisc.MultiPeriodDiscriminator(periods, **kw)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    back = porting.discriminator_variables(sd)
    fa = flax.traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray, variables))
    fb = flax.traverse_util.flatten_dict(back)
    assert fa.keys() == fb.keys() and all(np.array_equal(fa[k], fb[k]) for k in fa)
    w = rng.standard_normal(64).astype(np.float32)

    def scalar(outs, lib):
        yr, yg, fr, fg = outs
        flat = [s for s in yr + yg] + [f for fs in fr + fg for f in fs]
        return sum(lib.sum(x * lib.cos(x * float(w[i % 64]))) for i, x in enumerate(flat))

    want, jgrads = jax.jit(lambda v: (jmod.apply(v, y, y_hat), jax.grad(
        lambda v: scalar(jmod.apply(v, y, y_hat), jnp))(v)))(variables)
    got = port(torch.tensor(y), torch.tensor(y_hat))
    for g_list, w_list in zip(got, want):
        assert len(g_list) == len(w_list) == len(periods) + 1
        for a, b in zip(g_list, w_list):
            if isinstance(a, list):
                assert len(a) == len(b)
                for fa_, fb_ in zip(a, b):
                    # NCHW against JAX's NHWC for the period maps
                    fa_ = fa_.permute(0, 2, 3, 1) if fa_.ndim == 4 else fa_
                    assert fa_.shape == fb_.shape and rel(fa_.detach(), fb_) <= 1e-5
            else:
                assert a.shape == b.shape and rel(a.detach(), b) <= 1e-5
    names, params = zip(*port.named_parameters())
    grads = torch.autograd.grad(scalar(got, torch), params)
    want_sd = porting.discriminator_state_dict(jgrads)
    for n, g in zip(names, grads):
        assert rel(g, want_sd[n]) <= 1e-4, n


def test_make_gan_adam_matches_optax():
    rng = np.random.default_rng(3)
    arrays = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal(3).astype(np.float32)}
    tx = jstate.make_gan_adam(2e-3, decay=0.9)
    jp = {k: jnp.asarray(v) for k, v in arrays.items()}
    opt_state = tx.init(jp)
    params = [torch.nn.Parameter(torch.tensor(arrays[k])) for k in ("w", "b")]
    opt = tstate.make_gan_adam(params, 2e-3, decay=0.9)
    for step in range(5):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32) * (step + 1)
                 for k, v in arrays.items()}
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                                       opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.update([torch.tensor(grads[k]) for k in ("w", "b")])
        for k, p in zip(("w", "b"), params):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-6)
    assert opt.count == 5
    np.testing.assert_allclose(tstate.exponential_decay_schedule(2e-3, 0.9)(4),
                               2e-3 * 0.9 ** 4, rtol=1e-6)


@pytest.mark.parametrize("n_fft,mels,sr,hop,fmax", [(2048, 128, 32000, 640, None),
                                                    (1024, 32, 32000, 640, 8000.0)])
def test_vits_mel_spectrogram(n_fft, mels, sr, hop, fmax):
    """The default config's 128-mel loss mel and TINY's."""
    y = (0.3 * np.random.default_rng(n_fft).standard_normal((2, 8 * hop))).astype(np.float32)
    want = jmel.vits_mel_spectrogram(jnp.asarray(y), n_fft, mels, sr, hop, n_fft, 0.0, fmax)
    got = tmel.vits_mel_spectrogram(torch.tensor(y), n_fft, mels, sr, hop, n_fft, 0.0, fmax)
    assert got.shape == want.shape == (2, mels, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
