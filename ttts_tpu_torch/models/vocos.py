"""Vocos vocoder (ConvNeXt backbone + ISTFT head), port of ttts_tpu/models/
vocos.py: log-mel (B, T, 100) → 24 kHz waveform (B, (T-1)*hop). f32
throughout. State-dict keys are charactr/vocos-mel-24khz's (backbone.*,
head.out).

Also the reference's other backbone and heads, which `Vocos` does not
select (as in the JAX package) and a caller constructs directly:
VocosResNetBackbone (weight-normed HiFi-GAN ResBlock1s with layer scale,
vocoder/models.py:93-118) and the MDCT heads IMDCTSymExpHead /
IMDCTCosHead (vocoder/heads.py) over ops/mdct.py. Their keys follow the
reference modules' attributes (`embed`, `resnet.{i}.convs1/convs2/gamma`,
`out`); no released checkpoint was checked against them."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ttts_tpu_torch.config import VocosConfig
from ttts_tpu_torch.models.blocks import Conv1d
from ttts_tpu_torch.ops.mdct import imdct
from ttts_tpu_torch.ops.stft import istft


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


class VocosResBlock1(nn.Module):
    """For each dilation d: x + gamma * conv(lrelu(conv_d(lrelu(x)))), both
    convolutions weight-normed, "SAME" padded, leaky ReLU slope 0.1."""

    def __init__(self, dim: int, kernel_size: int = 3, dilations=(1, 3, 5),
                 layer_scale_init_value: float = 1.0):
        super().__init__()
        self.convs1 = nn.ModuleList(Conv1d(dim, dim, kernel_size, dilation=d, weight_norm=True)
                                    for d in dilations)
        self.convs2 = nn.ModuleList(Conv1d(dim, dim, kernel_size, weight_norm=True)
                                    for _ in dilations)
        self.gamma = nn.ParameterList(nn.Parameter(torch.full((dim, 1), layer_scale_init_value))
                                      for _ in dilations)

    def forward(self, x):
        for c1, c2, gamma in zip(self.convs1, self.convs2, self.gamma):
            xt = c2(F.leaky_relu(c1(F.leaky_relu(x, 0.1)), 0.1))
            x = x + gamma[:, 0] * xt
        return x


class VocosResNetBackbone(nn.Module):
    """mel (B, T, input_channels) → (B, T, dim): a weight-normed k=3 conv,
    then num_blocks VocosResBlock1s with layer scale 1 / num_blocks / 3."""

    def __init__(self, cfg: VocosConfig, num_blocks: int = 3):
        super().__init__()
        self.embed = Conv1d(cfg.input_channels, cfg.dim, 3, weight_norm=True)
        self.resnet = nn.Sequential(*(
            VocosResBlock1(cfg.dim, layer_scale_init_value=1.0 / num_blocks / 3)
            for _ in range(num_blocks)))

    def forward(self, mel):
        return self.resnet(self.embed(mel.float()))


def _symexp(x):
    return torch.sign(x) * (torch.exp(x.abs()) - 1.0)


class IMDCTSymExpHead(nn.Module):
    """(B, L, dim) → audio: symexp of a linear map to mdct_frame_len // 2
    coefficients, clipped to +-100, through the IMDCT."""

    def __init__(self, dim: int, mdct_frame_len: int, padding: str = "same",
                 clip_audio: bool = False):
        super().__init__()
        self.frame_len, self.padding, self.clip_audio = mdct_frame_len, padding, clip_audio
        self.out = nn.Linear(dim, mdct_frame_len // 2)

    def forward(self, x):
        audio = imdct(_symexp(self.out(x)).clamp(-1e2, 1e2), self.frame_len, self.padding)
        return audio.clamp(-1.0, 1.0) if self.clip_audio else audio


class IMDCTCosHead(nn.Module):
    """(B, L, dim) → audio: coefficients min(exp(m), 100) * cos(p) from one
    linear map to mdct_frame_len values, through the IMDCT."""

    def __init__(self, dim: int, mdct_frame_len: int, padding: str = "same",
                 clip_audio: bool = False):
        super().__init__()
        self.frame_len, self.padding, self.clip_audio = mdct_frame_len, padding, clip_audio
        self.out = nn.Linear(dim, mdct_frame_len)

    def forward(self, x):
        m, p = self.out(x).chunk(2, dim=-1)
        audio = imdct(torch.exp(m).clamp_max(1e2) * torch.cos(p), self.frame_len, self.padding)
        return audio.clamp(-1.0, 1.0) if self.clip_audio else audio
