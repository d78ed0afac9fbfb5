"""The codec, port of ttts_tpu/models/vqvae.py SynthesizerTrn, as a serving
model builds it (no enc_q): its extract path (`extract_code`: ref_enc
(MelStyleEncoder), enc_p (PosteriorAudioEncoder), the stride-2 proj and the
RVQ codebook), the one path the conditioning runs. The synthesis half
(enc_p_2 with MRTE, the coupling flow, the HiFi-GAN generator dec) is built
for its parameters alone and never run: the benchmark's seeded weights are
one draw over every key of the module (portbench/weights.py), so the
reference holds every key the program does. State-dict keys are the
reference's (ttts/vqvae/vq2.py)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from portbench.reference.config import VQVAEConfig
from portbench.reference.blocks import (
    AntiAliasedActivation,
    Conv1d,
    ConvTranspose1d,
    MelStyleEncoder,
    MultiHeadAttention,
    ResBlock1,
    TransformerEncoder,
    WN,
    sequence_mask,
)
from portbench.reference.quantize import rvq_encode


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

    def forward(self, spec, audio, x_mask, g=None, noise: Optional[torch.Tensor] = None):
        """→ (z, m, logs), (B, T, out_channels) each: z = (m + noise *
        exp(logs)) * x_mask, or m * x_mask without noise."""
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
        m, logs = stats.chunk(2, dim=-1)
        if noise is None:
            return m * x_mask, m, logs
        return (m + noise * torch.exp(logs)) * x_mask, m, logs


class _Codebook(nn.Module):
    """EnCodec EuclideanCodebook buffers (embed, embed_avg, cluster_size,
    inited); serving reads `embed` only."""

    def __init__(self, bins: int, dim: int):
        super().__init__()
        embed = torch.randn(bins, dim)
        self.register_buffer("embed", embed)
        self.register_buffer("embed_avg", embed.clone())
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

    def _embed(self) -> torch.Tensor:
        return torch.stack([layer._codebook.embed for layer in self.vq.layers])

    def encode(self, x):
        """x (B, T, D) → codes (n_q, B, T)."""
        return rvq_encode(self._embed(), x)


class MRTE(nn.Module):
    """Multi-reference timbre encoder: cross-attention from content frames
    to text, plus the global style (vq2.py:17-48; keys c_pre, text_pre,
    cross_attention, c_post)."""

    def __init__(self, content_channels: int, hidden_size: int = 512,
                 out_channels: int = 192, n_heads: int = 4):
        super().__init__()
        self.c_pre = Conv1d(content_channels, hidden_size, 1, padding=(0, 0))
        self.text_pre = Conv1d(content_channels, hidden_size, 1, padding=(0, 0))
        self.cross_attention = MultiHeadAttention(hidden_size, hidden_size, n_heads)
        self.c_post = Conv1d(hidden_size, out_channels, 1, padding=(0, 0))


class TextEncoder(nn.Module):
    """Quantized-content + text prior encoder, enc_p_2 (vq2.py:95-162):
    content and text each through a windowed transformer, MRTE, a second
    transformer, then the (m, logs) projection."""

    def __init__(self, out_channels: int, hidden_channels: int, filter_channels: int,
                 n_heads: int, n_layers: int, kernel_size: int, n_text_tokens: int = 256,
                 mrte_hidden: int = 512, p_dropout: float = 0.0):
        super().__init__()
        enc = lambda n: TransformerEncoder(  # noqa: E731
            hidden_channels, filter_channels, n_heads, n, kernel_size, p_dropout=p_dropout)
        self.encoder_ssl = enc(n_layers // 2)
        self.text_embedding = nn.Embedding(n_text_tokens, hidden_channels)
        self.encoder_text = enc(n_layers)
        self.mrte = MRTE(hidden_channels, hidden_size=mrte_hidden, out_channels=hidden_channels)
        self.encoder2 = enc(n_layers // 2)
        self.proj = Conv1d(hidden_channels, 2 * out_channels, 1, padding=(0, 0))


class ResidualCouplingLayer(nn.Module):
    """Mean-only affine coupling with a WN conditioner
    (modules.ResidualCouplingLayer; keys pre, enc, post: post is a 1x1 conv
    in the reference, a Dense in the JAX package)."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, gin_channels: int = 0):
        super().__init__()
        half = channels // 2
        self.pre = Conv1d(half, hidden_channels, 1, padding=(0, 0))
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers, gin_channels)
        self.post = Conv1d(hidden_channels, half, 1, padding=(0, 0))


class Flip(nn.Module):
    """Reverse the channel order (modules.Flip; no parameters)."""


class ResidualCouplingBlock(nn.Module):
    """n_flows x (coupling, flip), the codec's `flow` (vq2.py:210-252; keys
    flows.{2i} the couplings, flows.{2i+1} the flips)."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, n_flows: int = 4, gin_channels: int = 0):
        super().__init__()
        self.flows = nn.ModuleList()
        for _ in range(n_flows):
            self.flows.append(ResidualCouplingLayer(channels, hidden_channels, kernel_size,
                                                    dilation_rate, n_layers, gin_channels))
            self.flows.append(Flip())


class Generator(nn.Module):
    """HiFi-GAN generator, the codec's `dec` (vq2.py:341-415): conv_pre (+
    cond of the style), then per upsample leaky ReLU (slope 0.1) → ups.{i}
    → the mean of the ResBlock1 bank, then leaky ReLU at slope 0.01 (the
    JAX package's nn.leaky_relu default) → conv_post (no bias) → tanh.
    (B, T, C) → (B, T * prod(upsample_rates), 1)."""

    def __init__(self, initial_channel: int, resblock_kernel_sizes: Sequence[int],
                 resblock_dilation_sizes: Sequence[Sequence[int]],
                 upsample_rates: Sequence[int], upsample_initial_channel: int,
                 upsample_kernel_sizes: Sequence[int], gin_channels: int = 0):
        super().__init__()
        uic = upsample_initial_channel
        self.n_rb = len(resblock_kernel_sizes)
        self.conv_pre = Conv1d(initial_channel, uic, 7)
        if gin_channels:
            self.cond = Conv1d(gin_channels, uic, 1, padding=(0, 0))
        self.ups = nn.ModuleList(
            ConvTranspose1d(uic // 2 ** i, uic // 2 ** (i + 1), k, u, padding=(k - u) // 2,
                            weight_norm=True)
            for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)))
        self.resblocks = nn.ModuleList(
            ResBlock1(uic // 2 ** (i + 1), kk, dd)
            for i in range(len(upsample_rates))
            for kk, dd in zip(resblock_kernel_sizes, resblock_dilation_sizes))
        self.conv_post = Conv1d(uic // 2 ** len(upsample_rates), 1, 7, bias=False)


class SynthesizerTrn(nn.Module):
    """The codec (vq2.py:749). Channels-last: spec (B, T, spec_channels),
    wav (B, T*hop, 1), text (B, L) ids; the serving model, without enc_q."""

    def __init__(self, cfg: VQVAEConfig, spec_channels: int = 1025):
        super().__init__()
        c = self.cfg = cfg
        self.ref_enc = MelStyleEncoder(n_mel_channels=spec_channels,
                                       style_vector_dim=c.gin_channels)
        self.enc_p = PosteriorAudioEncoder(
            spec_channels, c.inter_channels, c.hidden_channels, 5, 1,
            c.posterior_wn_layers, gin_channels=c.gin_channels,
            down_rates=c.posterior_down_rates, down_kernels=c.posterior_down_kernels,
            down_channels=c.posterior_down_channels, rb_kernels=c.posterior_rb_kernels,
            rb_dils=c.posterior_rb_dilations)
        self.enc_p_2 = TextEncoder(
            c.inter_channels, c.hidden_channels, c.filter_channels, c.n_heads, c.n_layers,
            c.kernel_size, n_text_tokens=c.n_text_tokens, mrte_hidden=c.gin_channels,
            p_dropout=c.p_dropout)
        self.flow = ResidualCouplingBlock(
            c.inter_channels, c.hidden_channels, 5, 1, c.flow_wn_layers,
            n_flows=c.flow_layers, gin_channels=c.gin_channels)
        self.dec = Generator(
            c.inter_channels, c.resblock_kernel_sizes, c.resblock_dilation_sizes,
            c.upsample_rates, c.upsample_initial_channel, c.upsample_kernel_sizes,
            gin_channels=c.gin_channels)
        self.quantizer = ResidualVQ(c.inter_channels, c.n_q, c.codebook_bins)
        self.proj = Conv1d(c.inter_channels, c.inter_channels, 2, stride=2, padding=(0, 0))


    def extract_code(self, wav, spec, spec_lengths):
        """wav + spec → semantic VQ codes (B, n_q, T/2) (vq2.py:912-919)."""
        y_mask = sequence_mask(spec_lengths, spec.shape[1])
        ge = self.ref_enc(spec * y_mask, y_mask)
        x = self.enc_p(spec, wav, y_mask, g=ge)[0]
        x = self.proj(x * y_mask)
        return self.quantizer.encode(x).transpose(0, 1)


