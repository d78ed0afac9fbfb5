"""Gaussian diffusion engine (epsilon prediction, learned-range variance),
port of ttts_tpu/diffusion/gaussian.py (the reference's guided-diffusion
fork, ttts/utils/diffusion.py:162-1270): beta schedules, the q / posterior
math, p_mean_variance with the ramped classifier-free blend, the training
losses MSE(eps) + VLB on a frozen mean, SpacedDiffusion respacing, and the
ancestral and DDIM sampling loops.

Schedule tables are float64 numpy, computed as the JAX package computes
them; per-step coefficients are gathered as float32, as its `_extract` does.
Randomness is injected: `training_losses` takes its noise, and the loops
take their start and per-step noise (or a torch.Generator to draw them).
Model convention: channels-last mel (B, T, C); the network outputs 2C
channels, [eps; variance fraction].
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch


def get_named_beta_schedule(schedule_name: str, num_diffusion_timesteps: int) -> np.ndarray:
    """'linear' (Ho et al., scaled to any T) or 'cosine' (diffusion.py:83-110)."""
    if schedule_name == "linear":
        scale = 1000 / num_diffusion_timesteps
        return np.linspace(scale * 0.0001, scale * 0.02, num_diffusion_timesteps,
                           dtype=np.float64)
    if schedule_name == "cosine":
        def alpha_bar(t):
            return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

        return np.array([min(1 - alpha_bar((i + 1) / num_diffusion_timesteps)
                             / alpha_bar(i / num_diffusion_timesteps), 0.999)
                         for i in range(num_diffusion_timesteps)], dtype=np.float64)
    raise NotImplementedError(schedule_name)


def _extract(arr: np.ndarray, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Per-timestep coefficients as float32, broadcast to ndim dims."""
    out = torch.as_tensor(np.asarray(arr), dtype=torch.float32, device=t.device)[t.long()]
    return out.reshape(out.shape + (1,) * (ndim - 1))


def normal_kl(mean1, logvar1, mean2, logvar2):
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + (mean1 - mean2) ** 2 * torch.exp(-logvar2))


def approx_standard_normal_cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def discretized_gaussian_log_likelihood(x, means, log_scales):
    centered = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp_min(1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp_min(1e-12))
    log_delta = torch.log((cdf_plus - cdf_min).clamp_min(1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min, log_delta))


def _mean_over_rest(x):
    return x.mean(dim=tuple(range(1, x.ndim)))


@dataclass
class GaussianDiffusion:
    """Epsilon-prediction / learned-range diffusion over `betas`; model
    signature model(x, t_float, **model_kwargs) → (B, T, 2C)."""

    betas: np.ndarray
    rescale_timesteps: bool = False
    conditioning_free: bool = False
    conditioning_free_k: float = 1.0
    ramp_conditioning_free: bool = True

    def __post_init__(self):
        betas = np.asarray(self.betas, dtype=np.float64)
        assert (betas > 0).all() and (betas <= 1).all()
        self.num_timesteps = betas.shape[0]
        alphas = 1.0 - betas
        self.alphas_cumprod = np.cumprod(alphas)
        self.alphas_cumprod_prev = np.append(1.0, self.alphas_cumprod[:-1])
        self.alphas_cumprod_next = np.append(self.alphas_cumprod[1:], 0.0)
        self.sqrt_alphas_cumprod = np.sqrt(self.alphas_cumprod)
        self.sqrt_one_minus_alphas_cumprod = np.sqrt(1.0 - self.alphas_cumprod)
        self.log_one_minus_alphas_cumprod = np.log(1.0 - self.alphas_cumprod)
        self.sqrt_recip_alphas_cumprod = np.sqrt(1.0 / self.alphas_cumprod)
        self.sqrt_recipm1_alphas_cumprod = np.sqrt(1.0 / self.alphas_cumprod - 1)
        self.posterior_variance = (
            betas * (1.0 - self.alphas_cumprod_prev) / (1.0 - self.alphas_cumprod))
        self.posterior_log_variance_clipped = np.log(
            np.append(self.posterior_variance[1], self.posterior_variance[1:]))
        self.posterior_mean_coef1 = (
            betas * np.sqrt(self.alphas_cumprod_prev) / (1.0 - self.alphas_cumprod))
        self.posterior_mean_coef2 = (
            (1.0 - self.alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - self.alphas_cumprod))
        self.betas = betas

    # ----------------------------------------------------------------- q math

    def q_sample(self, x_start, t, noise):
        nd = x_start.ndim
        return (_extract(self.sqrt_alphas_cumprod, t, nd) * x_start
                + _extract(self.sqrt_one_minus_alphas_cumprod, t, nd) * noise)

    def q_posterior_mean_variance(self, x_start, x_t, t):
        nd = x_t.ndim
        mean = (_extract(self.posterior_mean_coef1, t, nd) * x_start
                + _extract(self.posterior_mean_coef2, t, nd) * x_t)
        return (mean, _extract(self.posterior_variance, t, nd),
                _extract(self.posterior_log_variance_clipped, t, nd))

    def _predict_xstart_from_eps(self, x_t, t, eps):
        nd = x_t.ndim
        return (_extract(self.sqrt_recip_alphas_cumprod, t, nd) * x_t
                - _extract(self.sqrt_recipm1_alphas_cumprod, t, nd) * eps)

    def _scale_timesteps(self, t):
        if self.rescale_timesteps:
            return t.float() * (1000.0 / self.num_timesteps)
        return t

    def _t_for_model(self, t):
        """Hook for SpacedDiffusion's timestep remap."""
        return self._scale_timesteps(t)

    def _learned_log_variance(self, var_values, t, nd):
        min_log = _extract(self.posterior_log_variance_clipped, t, nd)
        max_log = _extract(np.log(self.betas), t, nd)
        frac = (var_values + 1) / 2
        return frac * max_log + (1 - frac) * min_log

    # ------------------------------------------------------------ p(x_{t-1}|x_t)

    def p_mean_variance(self, model_fn, x, t, clip_denoised=False, model_kwargs=None):
        """Learned-range variance split and the optional classifier-free
        blend with ramped strength cfk * (1 - t/T) (diffusion.py:284-355)."""
        model_kwargs = model_kwargs or {}
        t_in = self._t_for_model(t)
        model_output, var_values = model_fn(x, t_in, **model_kwargs).chunk(2, dim=-1)
        if self.conditioning_free:
            out_nc = model_fn(x, t_in, conditioning_free=True, **model_kwargs)
            if self.ramp_conditioning_free:
                cfk = self.conditioning_free_k * (
                    1.0 - self._scale_timesteps(t).float()[0] / self.num_timesteps)
            else:
                cfk = self.conditioning_free_k
            model_output = (1 + cfk) * model_output - cfk * out_nc.chunk(2, dim=-1)[0]
        log_variance = self._learned_log_variance(var_values, t, x.ndim)
        pred_xstart = self._predict_xstart_from_eps(x, t, model_output)
        if clip_denoised:
            pred_xstart = pred_xstart.clamp(-1.0, 1.0)
        mean, _, _ = self.q_posterior_mean_variance(pred_xstart, x, t)
        return {"mean": mean, "variance": torch.exp(log_variance),
                "log_variance": log_variance, "pred_xstart": pred_xstart}

    # ---------------------------------------------------------------- training

    def training_losses(self, model_fn, x_start, t, noise, model_kwargs=None):
        """MSE(eps) + VLB with a frozen mean (diffusion.py:930-1010) at
        timesteps t (B,) with the given noise (x_start's shape). Returns
        per-example losses (B,) and x_t."""
        model_kwargs = model_kwargs or {}
        x_t = self.q_sample(x_start, t, noise)
        model_output, var_values = model_fn(x_t, self._t_for_model(t),
                                             **model_kwargs).chunk(2, dim=-1)
        # the VLB trains the variance only: the mean prediction is frozen
        vb = self._vb_terms_bpd(model_output.detach(), var_values, x_start, x_t, t)
        mse = _mean_over_rest((noise - model_output) ** 2)
        return {"loss": mse + vb, "mse": mse, "vb": vb, "x_t": x_t}

    def _vb_terms_bpd(self, model_output, var_values, x_start, x_t, t):
        true_mean, _, true_logvar = self.q_posterior_mean_variance(x_start, x_t, t)
        log_variance = self._learned_log_variance(var_values, t, x_t.ndim)
        pred_xstart = self._predict_xstart_from_eps(x_t, t, model_output)
        model_mean, _, _ = self.q_posterior_mean_variance(pred_xstart, x_t, t)
        kl = _mean_over_rest(normal_kl(true_mean, true_logvar, model_mean, log_variance))
        decoder_nll = -discretized_gaussian_log_likelihood(x_start, model_mean,
                                                           0.5 * log_variance)
        decoder_nll = _mean_over_rest(decoder_nll)
        return torch.where(t == 0, decoder_nll, kl) / math.log(2.0)

    # ---------------------------------------------------------------- samplers

    def _loop_noise(self, shape, noise, generator, device):
        """(num_timesteps + 1, *shape): [0] the start x_T, [1 + i] the noise
        of the i-th step (t = T-1-i); drawn from `generator` when not given."""
        if noise is None:
            noise = torch.randn((self.num_timesteps + 1,) + tuple(shape),
                                generator=generator, device=device)
        if tuple(noise.shape) != (self.num_timesteps + 1,) + tuple(shape):
            raise ValueError(f"noise {tuple(noise.shape)} != "
                             f"{(self.num_timesteps + 1,) + tuple(shape)}")
        return noise

    def p_sample_loop(self, model_fn, shape, noise=None, generator=None, device=None,
                      clip_denoised=False, model_kwargs=None):
        """Ancestral sampling (diffusion.py:654-712); see _loop_noise."""
        noise = self._loop_noise(shape, noise, generator, device)
        x = noise[0]
        for i, ts in enumerate(range(self.num_timesteps - 1, -1, -1)):
            t = torch.full((shape[0],), ts, dtype=torch.long, device=x.device)
            out = self.p_mean_variance(model_fn, x, t, clip_denoised, model_kwargs)
            x = out["mean"] + float(ts != 0) * torch.exp(0.5 * out["log_variance"]) * noise[1 + i]
        return x

    def ddim_sample_loop(self, model_fn, shape, noise=None, generator=None, device=None,
                         eta=0.0, clip_denoised=False, model_kwargs=None):
        """DDIM sampling (diffusion.py:819-928); see _loop_noise."""
        noise = self._loop_noise(shape, noise, generator, device)
        x = noise[0]
        for i, ts in enumerate(range(self.num_timesteps - 1, -1, -1)):
            t = torch.full((shape[0],), ts, dtype=torch.long, device=x.device)
            out = self.p_mean_variance(model_fn, x, t, clip_denoised, model_kwargs)
            nd = x.ndim
            eps = ((_extract(self.sqrt_recip_alphas_cumprod, t, nd) * x - out["pred_xstart"])
                   / _extract(self.sqrt_recipm1_alphas_cumprod, t, nd))
            abar = _extract(self.alphas_cumprod, t, nd)
            abar_prev = _extract(self.alphas_cumprod_prev, t, nd)
            sigma = (eta * torch.sqrt((1 - abar_prev) / (1 - abar))
                     * torch.sqrt(1 - abar / abar_prev))
            mean_pred = (out["pred_xstart"] * torch.sqrt(abar_prev)
                         + torch.sqrt(1 - abar_prev - sigma ** 2) * eps)
            x = mean_pred + float(ts != 0) * sigma * noise[1 + i]
        return x


class SpacedDiffusion(GaussianDiffusion):
    """Skip-step respacing (diffusion.py:1172-1270): keep `use_timesteps` of
    the base schedule, recompute the betas, and remap model timesteps
    through `timestep_map`."""

    def __init__(self, use_timesteps: Sequence[int], betas: np.ndarray, **kwargs):
        use_timesteps = sorted(set(int(i) for i in use_timesteps))
        self.use_timesteps = use_timesteps
        self.original_num_steps = len(betas)
        keep = set(use_timesteps)
        last, new_betas, self.timestep_map = 1.0, [], []
        for i, acp in enumerate(GaussianDiffusion(betas=betas).alphas_cumprod):
            if i in keep:
                new_betas.append(1 - acp / last)
                last = acp
                self.timestep_map.append(i)
        super().__init__(betas=np.array(new_betas), **kwargs)

    def _t_for_model(self, t):
        mapped = torch.as_tensor(np.array(self.timestep_map), dtype=torch.float32,
                                 device=t.device)[t.long()]
        if self.rescale_timesteps:
            mapped = mapped * (1000.0 / self.original_num_steps)
        return mapped


def space_timesteps(num_timesteps: int, section_counts) -> set:
    """'ddimN' / [N, ...] section respacing (diffusion.py:1223-1270)."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired:
                    return set(range(0, num_timesteps, i))
            raise ValueError(f"cannot create exactly {desired} steps with ddim stride")
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per, extra = divmod(num_timesteps, len(section_counts))
    start_idx, all_steps = 0, []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(f"cannot divide section of {size} steps into {section_count}")
        stride = 1 if section_count <= 1 else (size - 1) / (section_count - 1)
        cur = 0.0
        for _ in range(section_count):
            all_steps.append(start_idx + round(cur))
            cur += stride
        start_idx += size
    return set(all_steps)
