"""NANSY-style waveform perturbation for the codec's augmented branch, port
of ttts_tpu/data/augment.py (rebuild of ttts/vqvae/augment/): STFT →
parametric EQ (biquad peaking and shelving filters applied as frequency
responses, peq.py:6-120) → ISTFT → clip → peak-normalise, and the
formant / pitch warp (the reference's Praat 'Change gender', praat.py:26).

Parameter sampling follows ttts/vqvae/train.py:62-116 (formant 1.4, pitch
2.0, pitch range 1.5, 8 peaks log-spaced in [60 Hz, 10 kHz], q in [2, 5],
gain in [-12, 12] dB). The EQ and the device warp are tensor code that runs
on the batch's device inside the train step; their draws are arguments
(`sample_params` draws them from a torch.Generator; tests inject the JAX
package's). The host warp (`warp_batch_np`, `spectral_gender_warp`,
`praat_augment` behind the same optional parselmouth import) is this
package's own copy of the JAX package's numpy code, for loader threads.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ttts_tpu_torch.ops.stft import istft, overlap_add, stft

try:  # optional host dependency
    import parselmouth  # type: ignore

    HAVE_PRAAT = True
except ImportError:  # pragma: no cover
    HAVE_PRAAT = False


class AugmentConfig(NamedTuple):
    sampling_rate: int = 32000
    win_length: int = 2048
    hop_length: int = 640
    cutoff_lowpass: float = 60.0
    cutoff_highpass: float = 10000.0
    q_min: float = 2.0
    q_max: float = 5.0
    num_peak: int = 8
    g_min: float = -12.0
    g_max: float = 12.0
    formant_shift: float = 1.4
    pitch_shift: float = 2.0
    pitch_range: float = 1.5


# ---------------------------------------------------------------- biquads
# RBJ Audio-EQ-Cookbook responses on the rFFT grid (peq.py biquad:
# rfft(b) / rfft(a)).


def _biquad_response(b: torch.Tensor, a: torch.Tensor, n_fft: int) -> torch.Tensor:
    return torch.fft.rfft(b, n_fft, dim=-1) / torch.fft.rfft(a, n_fft, dim=-1)


def peaking_equalizer(center, gain_db, q, sr: int, n_fft: int) -> torch.Tensor:
    """center, gain, q broadcastable (...,) → response (..., n_fft//2+1)."""
    center, gain_db, q = torch.broadcast_tensors(*map(torch.as_tensor, (center, gain_db, q)))
    A = 10.0 ** (gain_db / 40.0)
    w0 = 2 * math.pi * center / sr
    alpha = torch.sin(w0) / (2 * q)
    cos = torch.cos(w0)
    b = torch.stack([1 + alpha * A, -2 * cos, 1 - alpha * A], dim=-1)
    a = torch.stack([1 + alpha / A, -2 * cos, 1 - alpha / A], dim=-1)
    return _biquad_response(b, a, n_fft)


def _shelving(cutoff, gain_db, q, sr: int, n_fft: int, low: bool) -> torch.Tensor:
    gain_db, q = torch.as_tensor(gain_db), torch.as_tensor(q)
    A = 10.0 ** (gain_db / 40.0)
    w0 = 2 * math.pi * torch.as_tensor(cutoff, dtype=gain_db.dtype) / sr
    cos = torch.cos(w0)
    alpha = torch.sin(w0) / (2 * q)
    two_sqrtA_alpha = 2 * torch.sqrt(A) * alpha
    if low:
        b0 = A * ((A + 1) - (A - 1) * cos + two_sqrtA_alpha)
        b1 = 2 * A * ((A - 1) - (A + 1) * cos)
        b2 = A * ((A + 1) - (A - 1) * cos - two_sqrtA_alpha)
        a0 = (A + 1) + (A - 1) * cos + two_sqrtA_alpha
        a1 = -2 * ((A - 1) + (A + 1) * cos)
        a2 = (A + 1) + (A - 1) * cos - two_sqrtA_alpha
    else:
        b0 = A * ((A + 1) + (A - 1) * cos + two_sqrtA_alpha)
        b1 = -2 * A * ((A - 1) + (A + 1) * cos)
        b2 = A * ((A + 1) + (A - 1) * cos - two_sqrtA_alpha)
        a0 = (A + 1) - (A - 1) * cos + two_sqrtA_alpha
        a1 = 2 * ((A - 1) - (A + 1) * cos)
        a2 = (A + 1) - (A - 1) * cos - two_sqrtA_alpha
    b = torch.stack(torch.broadcast_tensors(b0, b1, b2), dim=-1)
    a = torch.stack(torch.broadcast_tensors(a0, a1, a2), dim=-1)
    return _biquad_response(b, a, n_fft)


def low_shelving(cutoff, gain_db, q, sr: int, n_fft: int) -> torch.Tensor:
    return _shelving(cutoff, gain_db, q, sr, n_fft, low=True)


def high_shelving(cutoff, gain_db, q, sr: int, n_fft: int) -> torch.Tensor:
    return _shelving(cutoff, gain_db, q, sr, n_fft, low=False)


# ----------------------------------------------------------------- augment


def peak_centers(cfg: AugmentConfig) -> np.ndarray:
    """num_peak log-spaced centres between the cutoffs (augment/__init__.py:28-35)."""
    f_min, f_max, peaks = cfg.cutoff_lowpass, cfg.cutoff_highpass, cfg.num_peak
    idx = np.arange(peaks + 2)[1:-1]
    return f_min * (f_max / f_min) ** (idx / (peaks + 1))


def _shift(u: torch.Tensor, inv: torch.Tensor, max_val: float) -> torch.Tensor:
    """v = 1 + u (max - 1), inverted where `inv`: a shift factor in [1, max]
    or its reciprocal (vqvae/train.py:62-99)."""
    v = 1.0 + u * (max_val - 1.0)
    return torch.where(inv, 1.0 / v, v)


def sample_params(generator: Optional[torch.Generator], batch: int,
                  cfg: AugmentConfig) -> Dict[str, torch.Tensor]:
    """Random augmentation parameters (CPU tensors, (batch,) or (batch,
    num_peak + 2)): the three shift factors, drawn in [1, max] and inverted
    for half the draws, and the EQ's quality powers in [0, 1) and gains in
    [g_min, g_max)."""

    def shift(max_val):
        u = torch.rand(batch, generator=generator)
        return _shift(u, torch.rand(batch, generator=generator) < 0.5, max_val)

    p = {"formant_shift": shift(cfg.formant_shift), "pitch_shift": shift(cfg.pitch_shift),
         "pitch_range": shift(cfg.pitch_range)}
    p["quality_power"] = torch.rand(batch, cfg.num_peak + 2, generator=generator)
    p["gain"] = cfg.g_min + (cfg.g_max - cfg.g_min) * torch.rand(
        batch, cfg.num_peak + 2, generator=generator)
    return p


def apply_peq(wavs: torch.Tensor, quality_power: torch.Tensor, gain: torch.Tensor,
              cfg: AugmentConfig) -> torch.Tensor:
    """STFT-domain parametric EQ (augment/__init__.py:56-100): wavs (B, T),
    quality_power and gain (B, num_peak + 2) → (B, T'), clipped to [-1, 1]
    and peak-normalised."""
    n = cfg.win_length
    dev = wavs.device
    quality_power, gain = quality_power.to(dev), gain.to(dev)
    spec = stft(wavs, n, cfg.hop_length, n, center=True)  # (B, F, T')
    q = cfg.q_min * (cfg.q_max / cfg.q_min) ** quality_power
    centers = torch.as_tensor(peak_centers(cfg), dtype=torch.float32, device=dev)[None]
    peaks = torch.prod(peaking_equalizer(centers, gain[:, :-2], q[:, :-2], cfg.sampling_rate,
                                         n), dim=1)
    lowpass = low_shelving(cfg.cutoff_lowpass, gain[:, -2], q[:, -2], cfg.sampling_rate, n)
    highpass = high_shelving(cfg.cutoff_highpass, gain[:, -1], q[:, -1], cfg.sampling_rate, n)
    spec = spec * (peaks * highpass * lowpass)[:, :, None]
    out = istft(spec, n, cfg.hop_length, n, padding="center").clamp(-1.0, 1.0)
    return out / out.abs().amax(dim=-1, keepdim=True).clamp_min(1e-7)


# ------------------------------------------------- formant/pitch warp (host)
# The JAX package's Praat-free 'Change gender' (augment/praat.py:26):
# constant-ratio pitch shift (phase-vocoder stretch + resample) and a
# cepstral spectral-envelope warp for the formant factor. numpy, host-side:
# the reference's parselmouth call is CPU-side too. Praat stays the
# optional exact path.


def _stft_np(x: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    pad = n_fft // 2
    x = np.pad(x, (pad, pad), mode="reflect")
    win = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft)
    n_frames = 1 + (len(x) - n_fft) // hop
    idx = np.arange(n_fft)[None] + hop * np.arange(n_frames)[:, None]
    return np.fft.rfft(x[idx] * win, axis=-1).T  # (F, T)


def _istft_np(S: np.ndarray, n_fft: int, hop: int, length: int) -> np.ndarray:
    win = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft)
    frames = np.fft.irfft(S.T, n=n_fft, axis=-1) * win
    t = S.shape[1]
    out = np.zeros(n_fft + hop * (t - 1))
    norm = np.zeros_like(out)
    for i in range(t):  # overlap-add (host path, small clips)
        out[i * hop: i * hop + n_fft] += frames[i]
        norm[i * hop: i * hop + n_fft] += win ** 2
    out = out / np.maximum(norm, 1e-8)
    pad = n_fft // 2
    return out[pad: pad + length]


def _phase_vocoder(S: np.ndarray, rate: float, n_fft: int, hop: int) -> np.ndarray:
    """Phase-vocoder time stretch: T/rate frames at unchanged pitch."""
    f, t = S.shape
    steps = np.arange(0, t, rate)
    Sp = np.pad(S, ((0, 0), (0, 2)))
    idx = steps.astype(np.int64)
    frac = (steps - idx)[None, :]
    mag = (1 - frac) * np.abs(Sp[:, idx]) + frac * np.abs(Sp[:, idx + 1])
    phi_adv = (2 * np.pi * hop * np.arange(f) / n_fft)[:, None]
    dphase = np.angle(Sp[:, idx + 1]) - np.angle(Sp[:, idx]) - phi_adv
    dphase -= 2 * np.pi * np.round(dphase / (2 * np.pi))
    inc = phi_adv + dphase
    phase = np.angle(S[:, :1]) + np.concatenate(
        [np.zeros((f, 1)), np.cumsum(inc[:, :-1], axis=1)], axis=1)
    return mag * np.exp(1j * phase)


def _pitch_shift_np(x: np.ndarray, factor: float, n_fft: int = 1024,
                    hop: int = 256) -> np.ndarray:
    """Pitch (and formants) x `factor`, duration kept: stretch to
    length * factor, then resample back to the length."""
    S = _stft_np(x, n_fft, hop)
    S2 = _phase_vocoder(S, 1.0 / factor, n_fft, hop)
    y = _istft_np(S2, n_fft, hop, int(round(len(x) * factor)))
    pos = np.arange(len(x)) * (len(y) - 1) / max(len(x) - 1, 1)
    return np.interp(pos, np.arange(len(y)), y)


def _formant_warp_np(x: np.ndarray, factor: float, n_fft: int = 1024,
                     hop: int = 256, lifter: int = 32) -> np.ndarray:
    """The spectral envelope's frequency axis x `factor` (cepstral lifter
    envelope; the excitation and pitch untouched)."""
    S = _stft_np(x, n_fft, hop)
    f = S.shape[0]
    logm = np.log(np.abs(S) + 1e-8)
    cep = np.fft.irfft(logm, axis=0)
    cep[lifter:-lifter] = 0.0
    env = np.fft.rfft(cep, n=2 * (f - 1), axis=0).real[:f]
    src = np.arange(f) / factor
    lo = np.clip(src.astype(np.int64), 0, f - 2)
    fr = np.clip(src - lo, 0.0, 1.0)[:, None]
    env_w = (1 - fr) * env[lo] + fr * env[lo + 1]
    return _istft_np(S * np.exp(env_w - env), n_fft, hop, len(x))


def spectral_gender_warp(wav: np.ndarray, sr: int, formant_shift: float,
                         pitch_shift: float, pitch_range: float = 1.0) -> np.ndarray:
    """Praat-free 'Change gender': pitch x pitch_shift, formants x
    formant_shift, duration kept; pitch_range is Praat's alone."""
    y = np.asarray(wav, np.float64)
    p = float(pitch_shift)
    if abs(p - 1.0) > 1e-3:
        y = _pitch_shift_np(y, p)
    g = float(formant_shift) / p  # the pitch shift already scaled formants by p
    if abs(g - 1.0) > 1e-3:
        y = _formant_warp_np(y, g)
    peak = np.max(np.abs(y))
    if peak > 1.0:
        y = y / peak
    return y.astype(np.float32)


def praat_augment(wav: np.ndarray, sr: int, formant_shift: float,
                  pitch_shift: float, pitch_range: float) -> np.ndarray:
    """Praat 'Change gender' (augment/praat.py:26), host-side; the numpy
    spectral warp when parselmouth is not installed."""
    if not HAVE_PRAAT:
        return spectral_gender_warp(wav, sr, formant_shift, pitch_shift, pitch_range)
    snd = parselmouth.Sound(wav.astype(np.float64), sampling_frequency=sr)
    pitch = parselmouth.praat.call(snd, "To Pitch", 0.8 / 75, 75, 600)
    ndpit = pitch.selected_array["frequency"]
    nonzero = ndpit[ndpit > 1e-5]
    pitch_median = float(np.median(nonzero)) if len(nonzero) else 0.0
    out = parselmouth.praat.call((snd, pitch), "Change gender", formant_shift,
                                 pitch_median * pitch_shift, pitch_range, 1.0)
    return np.asarray(out.values)[0].astype(np.float32)


def warp_batch_np(rng: "np.random.Generator", wavs: np.ndarray, cfg: AugmentConfig,
                  max_retries: int = 4, workers: int = 8) -> np.ndarray:
    """The host formant / pitch warp of a (B, T) batch with the reference's
    parameter sampling and retry on a non-finite result (vqvae/train.py:
    62-116), one child generator per clip (rng.spawn) so that the clips warp
    concurrently in threads and deterministically; serially when parselmouth
    drives Praat, whose interpreter is not thread-safe."""
    from concurrent.futures import ThreadPoolExecutor

    n = wavs.shape[0]
    if n == 0:
        return np.empty_like(wavs)
    if HAVE_PRAAT:
        workers = 1
    try:
        child = rng.spawn(n)
    except AttributeError:  # numpy < 1.25
        child = [np.random.default_rng(int(rng.integers(2 ** 63))) for _ in range(n)]
    t = wavs.shape[1]
    out = np.empty_like(wavs)

    def one(i: int):
        r = child[i]

        def shift(mx: float) -> float:
            v = r.uniform(1.0, mx)
            return 1.0 / v if r.random() < 0.5 else v

        y = wavs[i]
        for _ in range(max_retries):
            cand = praat_augment(wavs[i], cfg.sampling_rate, shift(cfg.formant_shift),
                                 shift(cfg.pitch_shift), shift(cfg.pitch_range))
            if np.isfinite(cand).all():
                y = cand
                break
        y = y[:t]
        out[i, :len(y)] = y
        out[i, len(y):] = 0.0

    if workers <= 1:
        for i in range(n):
            one(i)
        return out
    with ThreadPoolExecutor(max_workers=min(workers, n)) as pool:
        list(pool.map(one, range(n)))
    return out


def augment_batch(generator: Optional[torch.Generator], wavs: torch.Tensor,
                  cfg: AugmentConfig, use_praat: bool = True,
                  max_retries: int = 4) -> torch.Tensor:
    """The EQ then, with `use_praat`, the host warp, drawing new parameters
    until the result is finite (vqvae/train.py:100-116). wavs (B, T)."""
    out = None
    for _ in range(max_retries):
        p = sample_params(generator, wavs.shape[0], cfg)
        cand = apply_peq(wavs, p["quality_power"], p["gain"], cfg)
        if use_praat:
            host = cand.detach().cpu().numpy()
            host = np.stack([
                praat_augment(host[i], cfg.sampling_rate, float(p["formant_shift"][i]),
                              float(p["pitch_shift"][i]), float(p["pitch_range"][i])
                              )[:host.shape[1]]
                for i in range(host.shape[0])])
            cand = torch.from_numpy(host).to(wavs.device)
        if bool(torch.isfinite(cand).all()):
            return cand
        out = cand
    return torch.nan_to_num(out if out is not None else wavs)


# --------------------------------------------- formant/pitch warp (device)
# The tensor form of spectral_gender_warp (JAX's in-jit warp, vmapped over
# the clips): the same phase-vocoder pitch stretch, resample and cepstral
# formant warp at static shapes (the stretch renders onto a ceil(max_factor)
# x frame budget and the resample reads only the valid prefix), on the
# batch's device and over the whole (B, T) batch at once, each clip with
# its own factors, so that the warp rides the train step instead of the
# loader.


def _stft_t(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    return stft(x, n_fft, hop, center=True)  # (B, F, T)


def _istft_t(S: torch.Tensor, n_fft: int, hop: int, length: int,
             frame_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """S (B, F, T) → (B, length); frame_valid (B, T) masks frames out of
    both the signal and the window-squared normalisation."""
    n = torch.arange(n_fft, device=S.device)
    win = 0.5 - 0.5 * torch.cos(2 * math.pi * n / n_fft)
    frames = torch.fft.irfft(S.transpose(1, 2), n=n_fft, dim=-1) * win
    b, _, t = S.shape
    valid = (torch.ones(b, t, device=S.device) if frame_valid is None
             else frame_valid.to(frames.dtype))
    frames = frames * valid[..., None]
    out = overlap_add(frames, hop)
    norm = overlap_add(valid[..., None] * (win ** 2), hop)
    out = out / norm.clamp_min(1e-8)
    pad = n_fft // 2
    return out[:, pad: pad + length]


def _wrap(x: torch.Tensor) -> torch.Tensor:
    return x - 2 * math.pi * torch.round(x / (2 * math.pi))


def _take(x: torch.Tensor, idx: torch.Tensor, dim: int) -> torch.Tensor:
    """x gathered along `dim` at per-clip indices idx (B, n), the same for
    every other index: (B, F, T) x at idx (B, n) along 2 → (B, F, n)."""
    shape = list(x.shape)
    shape[dim] = idx.shape[1]
    view = [idx.shape[0]] + [1] * (x.dim() - 1)
    view[dim] = idx.shape[1]
    return x.gather(dim, idx.reshape(view).expand(shape))


def _phase_vocoder_t(S: torch.Tensor, rate: torch.Tensor, n_fft: int, hop: int,
                     t_out: int) -> torch.Tensor:
    """Phase-vocoder stretch of S (B, F, T) at per-clip `rate` (B,) onto a
    fixed t_out-frame grid; frames past a clip's stretched end carry junk
    that the caller's resample never reads."""
    b, f, t = S.shape
    steps = torch.arange(t_out, device=S.device)[None] * rate[:, None]
    idx = steps.to(torch.int32).clamp(0, t - 1).long()
    idx1 = (idx + 1).clamp(0, t - 1)
    frac = (steps - idx)[:, None, :]
    mag, ang = S.abs(), torch.angle(S)
    mag = (1 - frac) * _take(mag, idx, 2) + frac * _take(mag, idx1, 2)
    phi_adv = (2 * math.pi * hop * torch.arange(f, device=S.device) / n_fft)[:, None]
    dphase = _wrap(_take(ang, idx1, 2) - _take(ang, idx, 2) - phi_adv)
    # wrap the increments before the cumulative sum: phases matter mod 2 pi,
    # and the unwrapped sum outgrows float32 over thousands of frames
    inc = _wrap(phi_adv + dphase)
    phase = ang[..., :1] + torch.cat(
        [torch.zeros(b, f, 1, device=S.device), torch.cumsum(inc[..., :-1], dim=2)], dim=2)
    return torch.polar(mag, phase)


def _pitch_shift_t(x: torch.Tensor, factor: torch.Tensor, max_factor: float,
                   n_fft: int = 1024, hop: int = 256) -> torch.Tensor:
    """x (B, L) at per-clip pitch factors (B,), duration kept."""
    length = x.shape[1]
    budget = int(np.ceil(max_factor))
    S = _stft_t(x, n_fft, hop)
    t_out = budget * S.shape[2]
    S2 = _phase_vocoder_t(S, 1.0 / factor, n_fft, hop, t_out)
    # frames past the stretched end are clamped repeats: left out
    valid = (torch.arange(t_out, device=x.device)[None] * (1.0 / factor)[:, None]
             <= S.shape[2] - 1)
    y = _istft_t(S2, n_fft, hop, budget * length, frame_valid=valid)
    y_len = torch.round(length * factor)[:, None]
    pos = torch.arange(length, device=x.device)[None] * (y_len - 1.0) / max(length - 1, 1)
    lo = pos.to(torch.int32).clamp(0, budget * length - 2).long()
    fr = (pos - lo).clamp(0.0, 1.0)
    return (1 - fr) * y.gather(1, lo) + fr * y.gather(1, lo + 1)


def _formant_warp_t(x: torch.Tensor, factor: torch.Tensor, n_fft: int = 1024,
                    hop: int = 256, lifter: int = 32) -> torch.Tensor:
    """x (B, L) with its spectral envelope warped by per-clip factors (B,)."""
    S = _stft_t(x, n_fft, hop)
    f = S.shape[1]
    cep = torch.fft.irfft(torch.log(S.abs() + 1e-8), dim=1)
    r = torch.arange(cep.shape[1], device=x.device)
    cep = cep * ((r < lifter) | (r >= cep.shape[1] - lifter))[:, None]
    env = torch.fft.rfft(cep, n=2 * (f - 1), dim=1).real[:, :f]
    src = torch.arange(f, device=x.device)[None] / factor[:, None]
    lo = src.to(torch.int32).clamp(0, f - 2).long()
    fr = (src - lo).clamp(0.0, 1.0)[..., None]
    env_w = (1 - fr) * _take(env, lo, 1) + fr * _take(env, lo + 1, 1)
    return _istft_t(S * torch.exp(env_w - env), n_fft, hop, x.shape[1])


def gender_warp_t(wav: torch.Tensor, formant_shift: torch.Tensor, pitch_shift: torch.Tensor,
                  max_pitch: float) -> torch.Tensor:
    """The device 'Change gender' of (B, T) clips: pitch x pitch_shift,
    formants x formant_shift (both (B,)), duration kept. Both stages are
    computed and selected out per clip at a factor within 1e-3 of 1, the
    host path's skip rule (a phase vocoder at rate ~1 still decoheres
    phase)."""
    y_p = _pitch_shift_t(wav, pitch_shift, max_pitch)
    y = torch.where(((pitch_shift - 1.0).abs() > 1e-3)[:, None], y_p, wav)
    g = formant_shift / pitch_shift
    y_f = _formant_warp_t(y, g)
    y = torch.where(((g - 1.0).abs() > 1e-3)[:, None], y_f, y)
    peak = y.abs().amax(dim=1, keepdim=True)
    return torch.where(peak > 1.0, y / peak, y)


def warp_draws(generator: Optional[torch.Generator], batch: int,
               cfg: AugmentConfig) -> Dict[str, torch.Tensor]:
    """The device warp's per-clip factors (CPU tensors (batch,)): formant and
    pitch, each v ~ U(1, max) inverted with probability 1/2."""
    out = {}
    for name, mx in (("formant_shift", cfg.formant_shift), ("pitch_shift", cfg.pitch_shift)):
        u = torch.rand(batch, generator=generator)
        out[name] = _shift(u, torch.rand(batch, generator=generator) < 0.5, mx)
    return out


def warp_batch_device(wavs: torch.Tensor, factors: Dict[str, torch.Tensor],
                      cfg: AugmentConfig) -> torch.Tensor:
    """The formant / pitch warp of a (B, T) batch on its device with
    warp_draws' factors. A clip whose warp is not finite falls back to the
    unwarped clip (the reference's retry guarded Praat's edge cases; the
    spectral path is deterministic, so one attempt and the fallback keep the
    same contract)."""
    dev = wavs.device
    out = gender_warp_t(wavs, factors["formant_shift"].to(dev),
                        factors["pitch_shift"].to(dev), cfg.pitch_shift)
    finite = torch.isfinite(out).all(dim=1, keepdim=True)
    return torch.where(finite, out.to(wavs.dtype), wavs)
