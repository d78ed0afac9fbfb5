"""Residual vector quantization, the serving half: port of ttts_tpu/models/
quantize.py (`_nearest`, `rvq_encode`, `rvq_decode` and the eval branch of
`rvq_forward`). The EMA / k-means training half is not ported."""

from __future__ import annotations

from typing import Tuple

import torch

from ttts_tpu_torch.ops.cuda import vq


def nearest(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """argmin_j ||x_i - e_j||^2 → (N,) int64. x (N, D), embed (bins, D).
    The VQ kernel where its domain holds (vq.kernel_fits: D a multiple of
    32), else its plain version, as ttts_tpu's _nearest gates the Pallas
    kernel."""
    return vq.nearest(x.float(), embed.float()).long()


def rvq_encode(embed: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """embed (n_q, bins, D); x (B, T, D) → codes (n_q, B, T)."""
    return rvq_quantize(embed, x)[1]


def rvq_quantize(embed: torch.Tensor, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The eval forward (rvq_forward with train=False): embed (n_q, bins, D);
    x (B, T, D) → (quantized (B, T, D) = the sum of each layer's chosen
    codes, codes (n_q, B, T))."""
    b, t, d = x.shape
    residual = x.reshape(-1, d)
    quantized = torch.zeros_like(residual)
    codes = []
    for layer in embed:
        idx = nearest(residual, layer)
        quant = layer[idx]
        codes.append(idx.reshape(b, t))
        residual = residual - quant
        quantized = quantized + quant
    return quantized.reshape(b, t, d), torch.stack(codes)


def rvq_decode(embed: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """codes (n_q, B, T) → (B, T, D): the sum of each layer's codes."""
    out = torch.zeros(codes.shape[1:] + (embed.shape[-1],), dtype=embed.dtype,
                      device=embed.device)
    for layer, idx in zip(embed, codes):
        out = out + layer[idx]
    return out
