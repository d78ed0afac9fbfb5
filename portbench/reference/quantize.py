"""Residual vector quantization, port of ttts_tpu/models/quantize.py: the
serving half the codec's `extract_code` runs (`nearest`, `rvq_encode`,
`rvq_quantize` = the eval forward). The nearest-code search takes the VQ
kernel's plain version.
"""

from __future__ import annotations

from typing import Tuple

import torch

from portbench.reference.plain import vq


def nearest(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """argmin_j ||x_i - e_j||^2 → (N,) int64. x (N, D), embed (bins, D)."""
    return vq.nearest(x.float(), embed.float()).long()


def rvq_encode(embed: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """embed (n_q, bins, D); x (B, T, D) → codes (n_q, B, T)."""
    return rvq_quantize(embed, x)[1]


def rvq_quantize(embed: torch.Tensor, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The eval forward (JAX's rvq_forward with train=False): embed (n_q, bins, D);
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
