"""Group vector quantizer, port of ttts_tpu/models/group_quantizer.py
(reference ttts/vqvae/vq2.py Quantizer:571-616 + Quantizer_module:554-569),
the codec's shipped but unused alternative VQ: the embedding splits into
n_code_groups groups, each with its own codebook trained by gradient
(commitment 0.25 + codebook loss 1.0) rather than by EMA. Channels-last:
x (B, T, C). Keys quantizer_modules.{i}.embedding.weight.

Plain PyTorch, with no kernel: JAX's GroupQuantizer computes its own f32
distance product and never reaches the Pallas VQ kernel, and its codebooks
are parameters that train by gradient, where the kernel has no backward."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn


class _Module(nn.Module):
    def __init__(self, n_codes: int, dim: int):
        super().__init__()
        self.embedding = nn.Embedding(n_codes, dim)
        nn.init.uniform_(self.embedding.weight, -1.0 / n_codes, 1.0 / n_codes)


class GroupQuantizer(nn.Module):
    def __init__(self, embed_dim: int = 512, n_code_groups: int = 4, n_codes: int = 160):
        super().__init__()
        if embed_dim % n_code_groups:
            raise ValueError(f"embed_dim {embed_dim} is no multiple of {n_code_groups} groups")
        self.n_code_groups = n_code_groups
        d = embed_dim // n_code_groups
        self.quantizer_modules = nn.ModuleList(_Module(n_codes, d) for _ in range(n_code_groups))

    @staticmethod
    def _nearest(xg: torch.Tensor, cb: torch.Tensor):
        """xg (N, d), cb (codes, d) → (cb[idx] (N, d), idx (N,)), the f32
        product, ties to the first index."""
        dist = (xg * xg).sum(1, keepdim=True) - 2.0 * (xg @ cb.T) + (cb * cb).sum(1)[None]
        idx = torch.argmin(dist, dim=1)
        return cb[idx], idx

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x (B, T, C) → (quantized through the straight-through estimator,
        loss, codes (B, G, T))."""
        b, t, c = x.shape
        g = self.n_code_groups
        flat = x.reshape(-1, g, c // g)
        zq, codes = zip(*(self._nearest(flat[:, i], m.embedding.weight)
                          for i, m in enumerate(self.quantizer_modules)))
        zq = torch.stack(zq, dim=1).reshape(b, t, c)
        loss = 0.25 * torch.mean((zq.detach() - x) ** 2) + torch.mean((zq - x.detach()) ** 2)
        codes = torch.stack(codes).reshape(g, b, t).transpose(0, 1)
        return x + (zq - x).detach(), loss, codes

    def embed(self, codes) -> torch.Tensor:
        """codes (B, G, T) → (B, T, C) (vq2.py Quantizer.embed:606-616)."""
        return torch.cat([m.embedding.weight[codes[:, i]]
                          for i, m in enumerate(self.quantizer_modules)], dim=-1)
