"""PyTorch port parity of the codec's augmentation (ttts_tpu_torch.data.
augment against ttts_tpu.data.augment) on the CPU, in f32:

- the biquad responses (peaking, low and high shelving), the port's and
  JAX's each against the same formula in f64: within 2e-3 relative (L2),
  and per bin within 5e-4 from bin 32 (500 Hz) up. In f32 the responses
  are ill-conditioned near DC, where b(e^iw) and a(e^iw) nearly cancel
  (2 - 2 cos w0 ~ 4e-4 at the 60 Hz shelf): measured L2 errors 5.6e-4
  (port) and 4.4e-4 (JAX) for the low shelf, under 7e-5 for the others,
  per-bin errors up to 7.9e-3 below bin 32 on both sides and under 9e-5
  from bin 32 up; peak_centers exactly;
- apply_peq (STFT → filters → ISTFT → clip → peak-normalise) with JAX's
  sample_params draws injected: within 5e-3 relative (L2) of JAX's, and the
  port's f32 within 3e-3 of its own f64 run: those responses' f32 error
  reaches the output (measured 1.0e-3-1.3e-3 against JAX, 9.2e-4 against
  f64);
- the device formant / pitch warp with JAX's per-clip factors injected,
  within 1e-3 relative (L2) per clip: its phase vocoder sums wrapped phase
  increments over hundreds of frames in f32, and both sides round the
  angles and their cumulative sum in another order (measured 6.2e-5 to
  2.4e-4);
- warp_batch_np, the host warp, exactly equal under the same numpy
  generator;
- the device warp's non-finite fallback: a clip whose warp is not finite
  comes back unwarped, the others warped."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_vqvae_train import torch_threads  # noqa: F401 (autouse)
from ttts_tpu.data import augment as ja
from ttts_tpu_torch.data import augment as ta

CFG_J, CFG_T = ja.AugmentConfig(), ta.AugmentConfig()
RESP_BIN_TOL, RESP_TOL, PEQ_TOL, PEQ_F64_TOL, WARP_TOL = 5e-4, 2e-3, 5e-3, 3e-3, 1e-3


def _voice(seconds: float, seed: int, sr: int = 32000) -> np.ndarray:
    """A synthetic voiced clip: a gliding harmonic source with formant-like
    resonances and a little noise, peak 0.5."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 120 + 40 * np.sin(2 * np.pi * 0.7 * t + rng.uniform(0, 6))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    y = sum(np.sin(k * phase) / k * (1 + np.cos(2 * np.pi * k * f0 / 900)) for k in range(1, 20))
    y = y + 0.02 * rng.standard_normal(t.size)
    return (0.5 * y / np.abs(y).max()).astype(np.float32)


def test_config_and_peak_centers():
    assert CFG_T._asdict() == CFG_J._asdict()
    np.testing.assert_array_equal(ta.peak_centers(CFG_T), ja.peak_centers(CFG_J))


def _near(got, ref):
    got, ref = np.asarray(got, np.complex128), np.asarray(ref)
    assert np.max((np.abs(got - ref) / np.abs(ref))[..., 32:]) <= RESP_BIN_TOL
    assert np.linalg.norm(got - ref) <= RESP_TOL * np.linalg.norm(ref)


def test_biquad_responses():
    rng = np.random.default_rng(0)
    gain = rng.uniform(-12, 12, (3, 8)).astype(np.float32)
    q = rng.uniform(2, 5, (3, 8)).astype(np.float32)
    centers = ja.peak_centers(CFG_J)[None].astype(np.float32)
    t = lambda a, dt=torch.float32: torch.tensor(a, dtype=dt)  # noqa: E731
    ref = ta.peaking_equalizer(t(centers, torch.float64), t(gain, torch.float64),
                               t(q, torch.float64), 32000, 2048).numpy()
    _near(ta.peaking_equalizer(t(centers), t(gain), t(q), 32000, 2048).numpy(), ref)
    _near(ja.peaking_equalizer(jnp.asarray(centers), jnp.asarray(gain), jnp.asarray(q),
                               32000, 2048), ref)
    for name in ("low_shelving", "high_shelving"):
        cutoff = 60.0 if name == "low_shelving" else 10000.0
        ref = getattr(ta, name)(cutoff, t(gain[:, 0], torch.float64), t(q[:, 0], torch.float64),
                                32000, 2048).numpy()
        _near(getattr(ta, name)(cutoff, t(gain[:, 0]), t(q[:, 0]), 32000, 2048).numpy(), ref)
        _near(getattr(ja, name)(cutoff, jnp.asarray(gain[:, 0]), jnp.asarray(q[:, 0]),
                                32000, 2048), ref)


def test_apply_peq_with_jax_params():
    wavs = np.stack([_voice(1.0, 1), _voice(1.0, 2)])
    p = ja.sample_params(jax.random.key(4), 2, CFG_J)
    want = ja.apply_peq(jnp.asarray(wavs), p["quality_power"], p["gain"], CFG_J)
    qp, gain = np.asarray(p["quality_power"]), np.asarray(p["gain"])
    got = ta.apply_peq(torch.tensor(wavs), torch.tensor(qp), torch.tensor(gain), CFG_T)
    f64 = ta.apply_peq(*(torch.tensor(a, dtype=torch.float64) for a in (wavs, qp, gain)),
                       CFG_T).numpy()
    assert got.shape == want.shape == wavs.shape and got.dtype == torch.float32
    got = got.numpy()
    assert np.linalg.norm(got - want) <= PEQ_TOL * np.linalg.norm(want)
    assert np.linalg.norm(got - f64) <= PEQ_F64_TOL * np.linalg.norm(f64)
    assert np.abs(got).max() <= 1.0 + 1e-6 and np.abs(got - wavs).max() > 1e-2
    # the port's own draws: the same ranges
    tp = ta.sample_params(torch.Generator().manual_seed(0), 64, CFG_T)
    assert tp["gain"].min() >= -12 and tp["gain"].max() < 12
    assert 0 <= float(tp["quality_power"].min()) and float(tp["quality_power"].max()) < 1
    for k, mx in (("formant_shift", 1.4), ("pitch_shift", 2.0), ("pitch_range", 1.5)):
        v = tp[k]
        assert float(v.min()) >= 1 / mx - 1e-6 and float(v.max()) <= mx + 1e-6
        assert (v < 1).any() and (v > 1).any()


def _jax_factors(key, b):
    """The factors JAX's warp_batch_device draws from `key`."""
    kf, kp = jax.random.split(key)

    def draw(k, mx):
        v = jax.random.uniform(k, (b,), minval=1.0, maxval=mx)
        inv = jax.random.bernoulli(jax.random.fold_in(k, 1), 0.5, (b,))
        return np.asarray(jnp.where(inv, 1.0 / v, v))

    return {"formant_shift": draw(kf, CFG_J.formant_shift),
            "pitch_shift": draw(kp, CFG_J.pitch_shift)}


def test_device_warp_with_jax_factors():
    """Four clips, factors from two keys: pitch up and down, and a pitch
    factor of 1 (the stage selected out)."""
    wavs = np.stack([_voice(1.0, s) for s in range(4)])
    key = jax.random.key(7)
    want = np.asarray(jax.jit(lambda w: ja.warp_batch_device(key, w, CFG_J))(jnp.asarray(wavs)))
    f = _jax_factors(key, 4)
    assert (f["pitch_shift"] < 1).any() and (f["pitch_shift"] > 1).any()
    got = ta.warp_batch_device(torch.tensor(wavs), {k: torch.tensor(v) for k, v in f.items()},
                               CFG_T).numpy()
    for i in range(4):
        err = np.linalg.norm(got[i] - want[i]) / np.linalg.norm(want[i])
        assert err <= WARP_TOL, (i, err)
        assert np.abs(got[i] - wavs[i]).max() > 1e-2  # warped
    one = ta.gender_warp_t(torch.tensor(wavs[:1]), torch.tensor([1.4]), torch.tensor([1.0]),
                           2.0)[0]
    jone = ja.gender_warp_j(jnp.asarray(wavs[0]), jnp.asarray(1.4), jnp.asarray(1.0), 2.0)
    assert np.linalg.norm(one.numpy() - np.asarray(jone)) <= WARP_TOL * np.linalg.norm(jone)


def test_warp_draws_ranges():
    f = ta.warp_draws(torch.Generator().manual_seed(1), 256, CFG_T)
    for k, mx in (("formant_shift", 1.4), ("pitch_shift", 2.0)):
        v = f[k]
        assert float(v.min()) >= 1 / mx - 1e-6 and float(v.max()) <= mx + 1e-6
        assert 0.3 < float((v < 1).float().mean()) < 0.7


@pytest.mark.parametrize("workers", [1, 4])
def test_warp_batch_np_exact(workers):
    wavs = np.stack([_voice(0.7, 10 + s) for s in range(3)])
    want = ja.warp_batch_np(np.random.default_rng(3), wavs, CFG_J, workers=workers)
    got = ta.warp_batch_np(np.random.default_rng(3), wavs, CFG_T, workers=workers)
    np.testing.assert_array_equal(got, want)
    assert got.shape == wavs.shape and np.isfinite(got).all()


def test_device_warp_nonfinite_fallback(monkeypatch):
    wavs = np.stack([_voice(0.5, s) for s in range(3)])
    real = ta.gender_warp_t

    def broken(w, f, p, mx):
        out = real(w, f, p, mx)
        out[1, 100] = float("nan")  # one sample of the second clip
        return out

    monkeypatch.setattr(ta, "gender_warp_t", broken)
    f = {"formant_shift": torch.tensor([1.3, 0.8, 1.2]),
         "pitch_shift": torch.tensor([1.5, 0.6, 1.2])}
    got = ta.warp_batch_device(torch.tensor(wavs), f, CFG_T).numpy()
    np.testing.assert_array_equal(got[1], wavs[1])
    assert np.isfinite(got).all()
    assert np.abs(got[0] - wavs[0]).max() > 1e-2 and np.abs(got[2] - wavs[2]).max() > 1e-2


def test_augment_batch_is_the_eq_of_sample_params():
    """augment_batch without the host warp: the EQ with sample_params' draws
    from the same generator (a finite result on the first attempt)."""
    wavs = torch.tensor(np.stack([_voice(0.5, 20), _voice(0.5, 21)]))
    got = ta.augment_batch(torch.Generator().manual_seed(9), wavs, CFG_T, use_praat=False)
    p = ta.sample_params(torch.Generator().manual_seed(9), 2, CFG_T)
    assert torch.equal(got, ta.apply_peq(wavs, p["quality_power"], p["gain"], CFG_T))
