"""Multistep UniPC-2 (data prediction, B(h) variants bh1 / bh2), port of
ttts_tpu/diffusion/unipc.py on the same continuous linear VP schedule as
diffusion/dpm.py: an order-1 first step with a corrector, order-2
predictor-corrector steps 2 to steps-1 (the corrector's model evaluation is
the next step's previous one), and a last step at order 1 with no
corrector, so NFE == steps, as DPM-Solver++(2M). The schedule's scalars are
computed on the host in float64 (the JAX package computes them in f32)."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ttts_tpu_torch.diffusion.dpm import _alpha_sigma, _lambda


def uni_pc_sample(eps_fn: Callable, noise: torch.Tensor, steps: int = 30,
                  t_start: float = 1.0, t_end: float = 1e-3,
                  variant: str = "bh2") -> torch.Tensor:
    """eps_fn(x, t) → epsilon at continuous time t (a float); noise (B, T, C).
    Needs steps >= 2; variant "bh1" (B(h) = h) or "bh2" (B(h) = expm1(h))."""
    if steps < 2:
        raise ValueError("UniPC-2 needs steps >= 2")
    if variant not in ("bh1", "bh2"):
        raise NotImplementedError(variant)
    ts = np.linspace(t_start, t_end, steps + 1)
    lambdas = _lambda(ts)
    alphas, sigmas = zip(*(_alpha_sigma(t) for t in ts))

    def data_pred(x, i):
        return (x - sigmas[i] * eps_fn(x, float(ts[i]))) / alphas[i]

    def b_of_h(hh):
        return hh if variant == "bh1" else float(np.expm1(hh))

    x = noise
    m0 = data_pred(x, 0)
    # step 1: order 1, corrector rho_c = [0.5]
    hh = -(lambdas[1] - lambdas[0])
    x_t = (sigmas[1] / sigmas[0]) * x - alphas[1] * float(np.expm1(hh)) * m0
    m1 = data_pred(x_t, 1)
    x = x_t - alphas[1] * b_of_h(hh) * 0.5 * (m1 - m0)
    m_prev0, m_prev1 = m1, m0  # the model output at ts[i-1] and ts[i-2]
    # steps 2 .. steps-1: order-2 predictor (rho_p = [0.5]) and corrector
    for i in range(2, steps):
        h = lambdas[i] - lambdas[i - 1]
        r0 = (lambdas[i - 2] - lambdas[i - 1]) / h
        d1 = (m_prev1 - m_prev0) / r0
        hh = -h
        phi1 = float(np.expm1(hh))
        h_phi_k = phi1 / hh - 1.0
        bh = b_of_h(hh)
        b1 = h_phi_k / bh
        b2 = (h_phi_k / hh - 0.5) * 2.0 / bh
        rc0 = (b2 - b1) / (r0 - 1.0)  # rho_c = solve([[1, 1], [r0, 1]], [b1, b2])
        rc1 = b1 - rc0
        x_t = (sigmas[i] / sigmas[i - 1]) * x - alphas[i] * phi1 * m_prev0
        m_t = data_pred(x_t - alphas[i] * bh * 0.5 * d1, i)
        x = x_t - alphas[i] * bh * (rc0 * d1 + rc1 * (m_t - m_prev0))
        m_prev0, m_prev1 = m_t, m_prev0
    # the last step: order 1, no corrector
    h = lambdas[steps] - lambdas[steps - 1]
    return (sigmas[steps] / sigmas[steps - 1]) * x - alphas[steps] * float(np.expm1(-h)) * m_prev0
