"""DPM-Solver++(2M) with classifier-free guidance, port of ttts_tpu/
diffusion/dpm.py: the continuous linear VP schedule (beta0 = 0.1/4,
beta1 = 20/4), an epsilon model called with t*1000, order 2, time-uniform
steps, and cond/uncond batched as one 2B model call."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

BETA_0 = 0.1 / 4
BETA_1 = 20.0 / 4


def _log_alpha(t):
    return -0.25 * t ** 2 * (BETA_1 - BETA_0) - 0.5 * t * BETA_0


def _lambda(t):
    la = _log_alpha(t)
    return la - 0.5 * np.log(1.0 - np.exp(2.0 * la))


def _alpha_sigma(t):
    la = _log_alpha(t)
    return float(np.exp(la)), float(np.sqrt(1.0 - np.exp(2.0 * la)))


def dpm_solver_pp_2m_sample(eps_fn: Callable, noise: torch.Tensor, steps: int = 50,
                            t_start: float = 1.0, t_end: float = 1e-3) -> torch.Tensor:
    """eps_fn(x, t) → epsilon at continuous time t (a float); noise (B, T, C).
    The schedule's scalars are computed on the host in float64."""
    ts = np.linspace(t_start, t_end, steps + 1)
    lambdas = _lambda(ts)

    def data_pred(x, t):
        alpha, sigma = _alpha_sigma(t)
        return (x - sigma * eps_fn(x, float(t))) / alpha

    x = noise
    m_prev = data_pred(x, ts[0])
    alpha1, sigma1 = _alpha_sigma(ts[1])
    _, sigma0 = _alpha_sigma(ts[0])
    h1 = lambdas[1] - lambdas[0]
    x = (sigma1 / sigma0) * x - alpha1 * float(np.expm1(-h1)) * m_prev
    for i in range(1, steps):
        m_cur = data_pred(x, ts[i])
        h = lambdas[i + 1] - lambdas[i]
        r0 = (lambdas[i] - lambdas[i - 1]) / h
        d = m_cur + (1.0 / (2.0 * r0)) * (m_cur - m_prev)
        alpha_c, sigma_c = _alpha_sigma(ts[i + 1])
        _, sigma_p = _alpha_sigma(ts[i])
        x = (sigma_c / sigma_p) * x - alpha_c * float(np.expm1(-h)) * d
        m_prev = m_cur
    return x


def cfg_eps_fn(model_trunk: Callable, cond_emb: torch.Tensor, uncond_emb: torch.Tensor,
               guidance_scale: float) -> Callable:
    """eps_fn evaluating uncond and cond in ONE 2B-batch trunk call.
    model_trunk(x2b, t2b, emb2b) → (2B, T, 2C); epsilon is the first half of
    the channels; eps = eps_u + k * (eps_c - eps_u)."""
    emb2 = torch.cat([uncond_emb.to(cond_emb.dtype), cond_emb], dim=0)

    def eps_fn(x, t: float):
        b = x.shape[0]
        t2 = torch.full((2 * b,), t * 1000.0, dtype=torch.float32, device=x.device)
        eps = model_trunk(torch.cat([x, x], dim=0), t2, emb2).chunk(2, dim=-1)[0]
        eps_u, eps_c = eps[:b], eps[b:]
        return eps_u + guidance_scale * (eps_c - eps_u)

    return eps_fn
