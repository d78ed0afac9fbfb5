"""Audio quality / noise classifier for dataset filtering, port of
ttts_tpu/models/classifier.py (reference ttts/classifier/model.py:82-152,
AudioMiniEncoderWithClassifierHead): conv stem → depth x (resnet_blocks x
ResBlock + strided conv) → GroupNorm / SiLU / 1x1 to embedding_dim →
attn_blocks x AttentionBlock without a position bias → frame 0 → linear
head. Input is a mel spectrogram (B, T, spec_dim) channels-last. Each
ResBlock drops its second activation at cfg.dropout in training mode
(`model.train()`, JAX's deterministic=False), between the second SiLU and
the last convolution.

The strided convolutions pad as flax "SAME" does, which depends on T
(blocks.same_pad). The attention goes through `attention.attend`: at the
default width (512 channels, 4 heads, D=128) it is outside the kernel's
domain and takes the plain version.

Key names follow the reference modules' attributes (`enc.init`, `enc.res`,
`enc.final`, `enc.attn`, `head`); no released checkpoint was checked
against them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ttts_tpu_torch.config import ClassifierConfig
from ttts_tpu_torch.models.blocks import Conv1d, same_pad
from ttts_tpu_torch.models.diffusion_net import AttentionBlock, Conv1x1, GroupNorm32


class ClassifierResBlock(nn.Module):
    """x + conv(SiLU(GN(conv(SiLU(GN(x)))))) (`in_layers.0/.2`,
    `out_layers.0/.3`)."""

    def __init__(self, channels: int, kernel_size: int = 3, dropout: float = 0.0):
        super().__init__()
        self.in_layers = nn.Sequential(GroupNorm32(channels), nn.SiLU(),
                                       Conv1d(channels, channels, kernel_size))
        self.out_layers = nn.Sequential(GroupNorm32(channels), nn.SiLU(), nn.Dropout(dropout),
                                        Conv1d(channels, channels, kernel_size))

    def forward(self, x):
        return x + self.out_layers(self.in_layers(x))


class Downsample(nn.Module):
    """A k=3 conv at stride `factor` with flax "SAME" padding (`op`)."""

    def __init__(self, channels: int, out_channels: int, factor: int):
        super().__init__()
        self.op = Conv1d(channels, out_channels, 3, stride=factor)

    def forward(self, x):
        return self.op(x, same_pad(x.shape[1], 3, self.op.stride))


class AudioMiniEncoder(nn.Module):
    def __init__(self, c: ClassifierConfig):
        super().__init__()
        self.init = nn.Sequential(Conv1d(c.spec_dim, c.base_channels, 3))
        res, ch = [], c.base_channels
        for _ in range(c.depth):
            res += [ClassifierResBlock(ch, c.kernel_size, c.dropout)
                    for _ in range(c.resnet_blocks)]
            res.append(Downsample(ch, 2 * ch, c.downsample_factor))
            ch *= 2
        self.res = nn.Sequential(*res)
        self.final = nn.Sequential(GroupNorm32(ch), nn.SiLU(), Conv1x1(ch, c.embedding_dim))
        self.attn = nn.Sequential(*(AttentionBlock(c.embedding_dim, c.num_attn_heads,
                                                   relative_pos_embeddings=False)
                                    for _ in range(c.attn_blocks)))

    def forward(self, mel):
        """mel (B, T, spec_dim) → (B, embedding_dim), frame 0."""
        return self.attn(self.final(self.res(self.init(mel))))[:, 0]


class AudioMiniEncoderWithClassifierHead(nn.Module):
    def __init__(self, cfg: ClassifierConfig):
        super().__init__()
        self.cfg = cfg
        self.enc = AudioMiniEncoder(cfg)
        self.head = nn.Linear(cfg.embedding_dim, cfg.classes)

    def forward(self, mel, labels: Optional[torch.Tensor] = None):
        """mel (B, T, spec_dim) → logits (B, classes) f32; with `labels` (B,)
        the mean cross entropy against their one-hot targets, label 0
        softened by 20% spread over the other classes when
        distribute_zero_label (model.py:140-147)."""
        logits = self.head(self.enc(mel).float())
        if labels is None:
            return logits
        c = self.cfg
        target = F.one_hot(labels, c.classes).float()
        if c.distribute_zero_label:
            extra = torch.full((c.classes,), 0.2 / (c.classes - 1), device=logits.device)
            extra[0] = -0.2
            target = target + extra * (labels == 0)[:, None]
        return -(target * torch.log_softmax(logits, dim=-1)).sum(-1).mean()
