"""GAN and VAE losses of the codec, port of ttts_tpu/models/losses.py
(reference ttts/vqvae/losses.py:7-78)."""

from __future__ import annotations

import math

import torch


def feature_loss(fmap_r, fmap_g) -> torch.Tensor:
    """L1 feature matching x 2 (losses.py:7-15), the real features detached."""
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for fr, fg in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(fr.detach() - fg))
    return loss * 2.0


def discriminator_loss(disc_real, disc_gen):
    """LSGAN discriminator loss (losses.py:18-31) → (loss, real losses,
    generated losses)."""
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(disc_real, disc_gen):
        r = torch.mean((1.0 - dr) ** 2)
        g = torch.mean(dg ** 2)
        loss = loss + r + g
        r_losses.append(r)
        g_losses.append(g)
    return loss, r_losses, g_losses


def generator_loss(disc_gen):
    """LSGAN generator loss (losses.py:34-43) → (loss, per-discriminator losses)."""
    loss = 0.0
    gen_losses = []
    for dg in disc_gen:
        l = torch.mean((1.0 - dg) ** 2)  # noqa: E741
        gen_losses.append(l)
        loss = loss + l
    return loss, gen_losses


def mle_loss(z, m, logs, logdet, mask) -> torch.Tensor:
    """Negative normal log-likelihood for flow training (losses.py:64-78)."""
    l = torch.sum(logs) + 0.5 * torch.sum(torch.exp(-2 * logs) * ((z - m) ** 2))  # noqa: E741
    l = l - torch.sum(logdet)  # noqa: E741
    l = l / torch.sum(torch.ones_like(z) * mask)  # noqa: E741
    return l + 0.5 * math.log(2 * math.pi)


def kl_loss(z_p, logs_q, m_p, logs_p, z_mask, mask_sum=None) -> torch.Tensor:
    """Masked VITS KL divergence (losses.py:46-61). Inputs (B, T, C), mask
    (B, T, 1). `mask_sum` replaces the mask's sum as the denominator (data
    parallel: the ranks' mean of theirs, so that the ranks' mean of the
    loss is the global batch's)."""
    kl = logs_p - logs_q - 0.5
    kl = kl + 0.5 * ((z_p - m_p) ** 2) * torch.exp(-2.0 * logs_p)
    return torch.sum(kl * z_mask) / (torch.sum(z_mask) if mask_sum is None else mask_sum)
