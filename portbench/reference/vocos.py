"""Vocos vocoder (ConvNeXt backbone + ISTFT head), port of ttts_tpu/models/
vocos.py: log-mel (B, T, 100) → 24 kHz waveform (B, (T-1)*hop). f32
throughout. State-dict keys are charactr/vocos-mel-24khz's (backbone.*,
head.out)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.config import VocosConfig
from portbench.reference.stft import istft


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, intermediate_dim: int, layer_scale_init_value: float):
        super().__init__()
        self.dwconv = nn.Conv1d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, intermediate_dim)
        self.pwconv2 = nn.Linear(intermediate_dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init_value))

    def forward(self, x):
        y = self.dwconv(x.transpose(1, 2)).transpose(1, 2)
        y = self.pwconv2(F.gelu(self.pwconv1(self.norm(y))))
        return x + self.gamma * y


class VocosBackbone(nn.Module):
    def __init__(self, cfg: VocosConfig):
        super().__init__()
        self.embed = nn.Conv1d(cfg.input_channels, cfg.dim, 7, padding=3)
        self.norm = nn.LayerNorm(cfg.dim, eps=1e-6)
        self.convnext = nn.ModuleList(
            ConvNeXtBlock(cfg.dim, cfg.intermediate_dim, 1.0 / cfg.num_layers)
            for _ in range(cfg.num_layers))
        self.final_layer_norm = nn.LayerNorm(cfg.dim, eps=1e-6)

    def forward(self, mel):
        x = self.norm(self.embed(mel.transpose(1, 2)).transpose(1, 2))
        for blk in self.convnext:
            x = blk(x)
        return self.final_layer_norm(x)


class ISTFTHead(nn.Module):
    def __init__(self, dim: int, n_fft: int, hop_length: int, padding: str = "center"):
        super().__init__()
        self.n_fft, self.hop_length, self.padding = n_fft, hop_length, padding
        self.out = nn.Linear(dim, n_fft + 2)

    def forward(self, x):
        mag, p = self.out(x).chunk(2, dim=-1)
        mag = torch.exp(mag).clamp_max(1e2)
        spec = torch.polar(mag, p).transpose(1, 2)
        return istft(spec, self.n_fft, self.hop_length, self.n_fft, padding=self.padding)


class Vocos(nn.Module):
    """log-mel (B, T, n_mels) → waveform (B, (T-1)*hop)."""

    def __init__(self, cfg: VocosConfig):
        super().__init__()
        self.backbone = VocosBackbone(cfg)
        self.head = ISTFTHead(cfg.dim, cfg.n_fft, cfg.hop_length, cfg.padding)

    def forward(self, mel):
        return self.head(self.backbone(mel.float()))

