"""Codec extract path, port of ttts_tpu/models/vqvae.py: the parts of
SynthesizerTrn that `extract_code` runs — ref_enc (MelStyleEncoder), enc_p
(PosteriorAudioEncoder), the stride-2 proj and the RVQ codebook. enc_q,
enc_p_2, flow and dec are not built (the training / reconstruction half
waits). State-dict keys are the reference's (ttts/vqvae/vq2.py)."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ttts_tpu_torch.config import VQVAEConfig
from ttts_tpu_torch.models.blocks import (
    AntiAliasedActivation,
    Conv1d,
    MelStyleEncoder,
    ResBlock1,
    WN,
    sequence_mask,
)
from ttts_tpu_torch.models.quantize import rvq_encode


class PosteriorAudioEncoder(nn.Module):
    """Raw-audio downsample stack with HiFi-GAN ResBlocks and an anti-aliased
    SnakeBeta, concatenated with a WN encoding of the spectrogram
    (vq2.py:667-750)."""

    def __init__(self, in_channels: int, out_channels: int, hidden_channels: int,
                 kernel_size: int = 5, dilation_rate: int = 1, n_layers: int = 16,
                 gin_channels: int = 0,
                 down_rates: Sequence[int] = (10, 8, 2, 2, 2),
                 down_kernels: Sequence[int] = (16, 16, 8, 2, 2),
                 down_channels: Sequence[int] = (16, 32, 64, 96, 128, 192),
                 rb_kernels: Sequence[int] = (3, 7, 11),
                 rb_dils: Sequence[Sequence[int]] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))):
        super().__init__()
        ch = down_channels
        self.n_rb = len(rb_kernels)
        self.down_pre = Conv1d(1, ch[0], 7)
        self.downs = nn.ModuleList(
            Conv1d(ch[i], ch[i + 1], k, stride=u, padding=((k - 1) // 2, (k - 1) // 2),
                   weight_norm=True)
            for i, (u, k) in enumerate(zip(down_rates, down_kernels)))
        self.resblocks = nn.ModuleList(
            ResBlock1(ch[i + 1], kk, dd)
            for i in range(len(down_rates)) for kk, dd in zip(rb_kernels, rb_dils))
        self.activation_post = AntiAliasedActivation(ch[-1])
        self.conv_post = Conv1d(ch[-1], hidden_channels, 7)
        self.pre = Conv1d(in_channels, hidden_channels, 1, padding=(0, 0))
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers, gin_channels)
        self.proj = Conv1d(2 * hidden_channels, 2 * out_channels, 1, padding=(0, 0))

    def forward(self, spec, audio, x_mask, g=None):
        a = self.down_pre(audio)
        for i, down in enumerate(self.downs):
            a = down(a)
            rbs = self.resblocks[i * self.n_rb: (i + 1) * self.n_rb]
            a = sum(rb(a) for rb in rbs) / self.n_rb
        a = self.conv_post(self.activation_post(a))
        x = self.pre(spec) * x_mask
        x = self.enc(x, x_mask, g=g)
        x = torch.cat([x, a * x_mask], dim=-1)
        stats = self.proj(x) * x_mask
        m, _ = stats.chunk(2, dim=-1)
        return m * x_mask


class _Codebook(nn.Module):
    """EnCodec EuclideanCodebook buffers (embed, embed_avg, cluster_size,
    inited); serving reads `embed` only."""

    def __init__(self, bins: int, dim: int):
        super().__init__()
        self.register_buffer("embed", torch.randn(bins, dim))
        self.register_buffer("embed_avg", self.embed.clone())
        self.register_buffer("cluster_size", torch.ones(bins))
        self.register_buffer("inited", torch.ones(1))


class ResidualVQ(nn.Module):
    """Keys quantizer.vq.layers.{i}._codebook.*."""

    def __init__(self, dim: int, n_q: int = 1, bins: int = 1024):
        super().__init__()
        self.vq = nn.Module()
        self.vq.layers = nn.ModuleList(nn.Module() for _ in range(n_q))
        for layer in self.vq.layers:
            layer._codebook = _Codebook(bins, dim)

    def encode(self, x):
        """x (B, T, D) → codes (n_q, B, T)."""
        embed = torch.stack([layer._codebook.embed for layer in self.vq.layers])
        return rvq_encode(embed, x)


class SynthesizerTrn(nn.Module):
    """The codec's extract path (vq2.py:749). Channels-last: spec
    (B, T, spec_channels), wav (B, T*hop, 1)."""

    def __init__(self, cfg: VQVAEConfig, spec_channels: int = 1025):
        super().__init__()
        c = cfg
        self.ref_enc = MelStyleEncoder(n_mel_channels=spec_channels,
                                       style_vector_dim=c.gin_channels)
        self.enc_p = PosteriorAudioEncoder(
            spec_channels, c.inter_channels, c.hidden_channels, 5, 1,
            c.posterior_wn_layers, gin_channels=c.gin_channels,
            down_rates=c.posterior_down_rates, down_kernels=c.posterior_down_kernels,
            down_channels=c.posterior_down_channels, rb_kernels=c.posterior_rb_kernels,
            rb_dils=c.posterior_rb_dilations)
        self.quantizer = ResidualVQ(c.inter_channels, c.n_q, c.codebook_bins)
        self.proj = Conv1d(c.inter_channels, c.inter_channels, 2, stride=2, padding=(0, 0))

    def extract_code(self, wav, spec, spec_lengths):
        """wav + spec → semantic VQ codes (B, n_q, T/2) (vq2.py:912-919)."""
        y_mask = sequence_mask(spec_lengths, spec.shape[1])
        ge = self.ref_enc(spec * y_mask, y_mask)
        x = self.enc_p(spec, wav, y_mask, g=ge)
        x = self.proj(x * y_mask)
        return self.quantizer.encode(x).transpose(0, 1)
