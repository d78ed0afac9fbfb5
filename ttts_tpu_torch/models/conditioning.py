"""The GPT's alternative conditioning encoders, port of ttts_tpu/models/
conditioning.py (reference ttts/gpt/model.py:203-291 and gpt/perceiver.py:
225-317). Tensors are channels-last (B, T, C).

  - ConditioningEncoder: 1x1 conv of the mel, AttentionBlocks without a
    position bias (the attention kernel's no-bias mode through
    `attention.attend`), then the first frame or the mean.
  - MelEncoder: convolutions and ResBlocks reducing the mel 4x in time,
    with flax "SAME" padding on the stride-2 convolutions (blocks.same_pad).
  - PerceiverResampler: learned latents cross-attending to [x; latents],
    with a feed-forward, depth times, then a LayerNorm.

Key names follow the reference modules' attributes (`init`, `attn`;
`encoder`; `latents`, `layers`, `norm`). No released checkpoint was checked
against them. Where the JAX module departs from the reference (GroupNorm32
group counts, LayerNorm where the perceiver has RMSNorm, separate k and v
projections stored as one `to_kv`), the port follows the JAX module.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ttts_tpu_torch.models.blocks import Conv1d, same_pad
from ttts_tpu_torch.models.diffusion_net import AttentionBlock, Conv1x1, GroupNorm32


class ConditioningEncoder(nn.Module):
    def __init__(self, spec_dim: int = 80, embedding_dim: int = 512, attn_blocks: int = 6,
                 num_attn_heads: int = 8, mean: bool = False):
        super().__init__()
        self.mean = mean
        self.init = Conv1x1(spec_dim, embedding_dim)
        self.attn = nn.Sequential(*(AttentionBlock(embedding_dim, num_attn_heads,
                                                   relative_pos_embeddings=False)
                                    for _ in range(attn_blocks)))

    def forward(self, mel):
        """mel (B, T, spec_dim) → (B, embedding_dim)."""
        h = self.attn(self.init(mel))
        return h.mean(dim=1) if self.mean else h[:, 0]


class _MelResBlock(nn.Module):
    """relu(x + GN(conv(relu(GN(conv(x)))))) (`net.0`, `.1`, `.3`, `.4`)."""

    def __init__(self, chan: int):
        super().__init__()
        self.net = nn.Sequential(Conv1d(chan, chan, 3), GroupNorm32(chan), nn.ReLU(),
                                 Conv1d(chan, chan, 3), GroupNorm32(chan))

    def forward(self, x):
        return F.relu(x + self.net(x))


class MelEncoder(nn.Module):
    """mel (B, T, mel_channels) → (B, ceil(ceil(T/2)/2), channels)."""

    def __init__(self, channels: int, mel_channels: int = 80, resblocks_per_reduction: int = 2):
        super().__init__()
        c, n = channels, resblocks_per_reduction
        self.encoder = nn.Sequential(
            Conv1d(mel_channels, c // 4, 3),
            nn.Sequential(*(_MelResBlock(c // 4) for _ in range(n))),
            Conv1d(c // 4, c // 2, 3, stride=2), GroupNorm32(c // 2), nn.ReLU(),
            nn.Sequential(*(_MelResBlock(c // 2) for _ in range(n))),
            Conv1d(c // 2, c, 3, stride=2), GroupNorm32(c), nn.ReLU(),
            nn.Sequential(*(_MelResBlock(c) for _ in range(n))))

    def forward(self, mel):
        h = mel
        for m in self.encoder:  # every conv is k=3 with flax "SAME" padding
            h = m(h, same_pad(h.shape[1], 3, m.stride)) if isinstance(m, Conv1d) else m(h)
        return h


class _PerceiverAttention(nn.Module):
    """LayerNorms of the latents and of [x; latents], biasless q and kv
    projections (`to_kv` = [k; v]), keys masked with -1e9, biasless out."""

    def __init__(self, dim: int, dim_head: int, heads: int):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.norm_latents = nn.LayerNorm(dim, eps=1e-6)
        self.norm_context = nn.LayerNorm(dim, eps=1e-6)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, 2 * inner, bias=False)
        self.to_out = nn.Linear(inner, dim, bias=False)

    def forward(self, lat, x, mask: Optional[torch.Tensor]):
        b, h, dk = lat.shape[0], self.heads, self.dim_head
        q = self.to_q(self.norm_latents(lat)).reshape(b, -1, h, dk)
        k, v = (z.reshape(b, -1, h, dk) for z in
                self.to_kv(self.norm_context(torch.cat([x, lat], dim=1))).chunk(2, dim=-1))
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dk)
        if mask is not None:
            keep = torch.cat([mask, mask.new_ones(b, lat.shape[1])], dim=1)
            s = s.masked_fill(~keep[:, None, None, :], -1e9)
        a = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
        return self.to_out(a.reshape(b, -1, h * dk))


class _PerceiverFeedForward(nn.Module):
    """LayerNorm → Linear → GELU (tanh form, flax's default) → Linear."""

    def __init__(self, dim: int, mult: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.net = nn.Sequential(nn.Linear(dim, dim * mult), nn.GELU(approximate="tanh"),
                                 nn.Linear(dim * mult, dim))

    def forward(self, x):
        return self.net(self.norm(x))


class PerceiverResampler(nn.Module):
    """x (B, T, dim) [, bool mask (B, T)] → (B, num_latents, dim)."""

    def __init__(self, dim: int, depth: int = 2, num_latents: int = 32, dim_head: int = 64,
                 heads: int = 8, ff_mult: int = 4):
        super().__init__()
        self.latents = nn.Parameter(torch.randn(num_latents, dim) * 0.02)
        self.layers = nn.ModuleList(
            nn.ModuleList([_PerceiverAttention(dim, dim_head, heads),
                           _PerceiverFeedForward(dim, ff_mult)]) for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        lat = self.latents[None].expand(x.shape[0], -1, -1)
        for attn, ff in self.layers:
            lat = lat + attn(lat, x, mask)
            lat = lat + ff(lat)
        return self.norm(lat)
