"""Residual vector quantization, encode half: port of ttts_tpu/models/
quantize.py (`_nearest`, `rvq_encode`). The EMA / k-means training half is
not ported."""

from __future__ import annotations

import torch

from ttts_tpu_torch.ops.cuda.vq import vq_nearest


def nearest(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """argmin_j ||x_i - e_j||^2 → (N,) int64. x (N, D), embed (bins, D)."""
    return vq_nearest(x.float(), embed.float()).long()


def rvq_encode(embed: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """embed (n_q, bins, D); x (B, T, D) → codes (n_q, B, T)."""
    b, t, d = x.shape
    residual = x.reshape(-1, d)
    codes = []
    for layer in embed:
        idx = nearest(residual, layer)
        codes.append(idx.reshape(b, t))
        residual = residual - layer[idx]
    return torch.stack(codes)
