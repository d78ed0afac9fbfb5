"""Codec building blocks, port of ttts_tpu/models/blocks.py.

Tensors are channels-last (B, T, C) at every module boundary, masks (B, T, 1)
floats, as in the JAX package. Parameters carry the reference's torch names
(ttts/vqvae/modules.py, attentions.py, alias_free_torch) and torch layouts:
conv weights (out, in/groups, k), linear weights (out, in), weight-normed
convs as (weight_g, weight_v).

Dropout sits where the JAX package's blocks have it (WN's gate, the
attention probabilities, ConvFFN, TransformerEncoder's two branches,
MelStyleEncoder), at the same rates, and acts in train mode only
(`module.train()`): serving calls `.eval()`, so it computes as before.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

LRELU_SLOPE = 0.1


def sequence_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) lengths → (B, max_len, 1) float mask."""
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return (pos < lengths[:, None]).float()[..., None]


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


class Linear(nn.Linear):
    """nn.Linear on channels-last input, computing in its weight's dtype."""

    def forward(self, x):
        w = self.weight
        return F.linear(x.to(w.dtype), w, None if self.bias is None else self.bias.to(w.dtype))


class Conv1d(nn.Module):
    """1D conv on (B, T, C) with torch 'same' padding by default (explicit
    (left, right) padding otherwise, or per call: forward's `pad`); optional
    weight norm as g * v / ||v|| with the norm over (in, k), as flax
    nn.WeightNorm."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 dilation: int = 1, padding: Optional[Tuple[int, int]] = None,
                 bias: bool = True, weight_norm: bool = False, groups: int = 1):
        super().__init__()
        p = (kernel_size * dilation - dilation) // 2
        self.pad = tuple(padding) if padding is not None else (p, p)
        self.stride, self.dilation, self.groups = stride, dilation, groups
        w = torch.empty(out_ch, in_ch // groups, kernel_size)
        nn.init.kaiming_uniform_(w, a=math.sqrt(5))
        if weight_norm:
            self.weight_v = nn.Parameter(w)
            self.weight_g = nn.Parameter(w.norm(dim=(1, 2), keepdim=True))
        else:
            self.weight = nn.Parameter(w)
        self.weight_norm = weight_norm
        if bias:
            bound = 1.0 / math.sqrt(w[0].numel())
            self.bias = nn.Parameter(torch.empty(out_ch).uniform_(-bound, bound))
        else:
            self.register_parameter("bias", None)

    def kernel(self) -> torch.Tensor:
        if not self.weight_norm:
            return self.weight
        v = self.weight_v
        return v * torch.rsqrt((v * v).sum(dim=(1, 2), keepdim=True) + 1e-12) * self.weight_g

    def forward(self, x, pad: Optional[Tuple[int, int]] = None):
        w = self.kernel()
        y = F.pad(x.to(w.dtype).transpose(1, 2), pad or self.pad)
        b = None if self.bias is None else self.bias.to(w.dtype)
        y = F.conv1d(y, w, b, stride=self.stride, dilation=self.dilation, groups=self.groups)
        return y.transpose(1, 2)


class ConvTranspose1d(nn.Module):
    """Transposed 1D conv on (B, T, C) as torch's ConvTranspose1d(k, stride,
    padding): out_len = (T - 1) * stride - 2 * padding + k. The weight is
    (in, out, k). With weight norm it is the JAX module's parameterisation,
    trained as JAX trains it: v * g / max(||v||, 1e-12) with the norm over
    (in, k) per *output* channel (weight_g (1, out, 1)). (The reference's
    torch weight norm is per input channel: ttts_tpu's porting fuses such a
    checkpoint's weight and renormalises it per output channel.)"""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int,
                 padding: int = 0, weight_norm: bool = False):
        super().__init__()
        self.stride, self.padding = stride, padding
        bound = 1.0 / math.sqrt(out_ch * kernel_size)  # torch's fan-in of (in, out, k)
        w = torch.empty(in_ch, out_ch, kernel_size).uniform_(-bound, bound)
        if weight_norm:
            self.weight_v = nn.Parameter(w)
            self.weight_g = nn.Parameter(w.norm(dim=(0, 2), keepdim=True))
        else:
            self.weight = nn.Parameter(w)
        self.weight_norm = weight_norm
        self.bias = nn.Parameter(torch.empty(out_ch).uniform_(-bound, bound))


class LayerNorm(nn.Module):
    """LayerNorm over the channel axis with the reference's `gamma`, `beta`
    keys (modules.LayerNorm). Epsilon 1e-6, as the JAX package's flax
    nn.LayerNorm(); the reference's VITS LayerNorm uses 1e-5."""

    def __init__(self, channels: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))


# LayerNorm over the channel axis (modules.LayerNorm:20; ttts_tpu's
# LayerNorm1d): the same module under JAX's name
LayerNorm1d = LayerNorm


class SnakeBeta(nn.Module):
    """x + 1/(beta + 1e-9) * sin^2(alpha x), per-channel log-scale alpha, beta
    (stored as `alpha`, `beta` — the log values, reference naming)."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        alpha, beta = torch.exp(self.alpha), torch.exp(self.beta)
        return x + (1.0 / (beta + 1e-9)) * torch.sin(alpha * x) ** 2


def _kaiser_sinc_filter1d(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """(kernel_size,) lowpass kernel (alias_free_torch/filter.py)."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4 * half_width
    a = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)
    time = (np.arange(-half_size, half_size) + 0.5) if even else (np.arange(kernel_size) - half_size)
    filt = 2 * cutoff * window * np.sinc(2 * cutoff * time)
    filt /= filt.sum()
    return filt.astype(np.float32)


class AntiAliasedActivation(nn.Module):
    """2x upsample → SnakeBeta → 2x downsample (alias_free_torch/act.py);
    the activation is `act` (reference key activation_post.act.*)."""

    def __init__(self, channels: int, up_kernel: int = 12, down_kernel: int = 12):
        super().__init__()
        self.act = SnakeBeta(channels)
        self.up_kernel, self.down_kernel = up_kernel, down_kernel
        self.register_buffer("filt_up", torch.from_numpy(
            _kaiser_sinc_filter1d(0.25, 0.3, up_kernel)), persistent=False)
        self.register_buffer("filt_dn", torch.from_numpy(
            _kaiser_sinc_filter1d(0.25, 0.3, down_kernel)), persistent=False)

    def forward(self, x):
        ratio, k, c = 2, self.up_kernel, x.shape[-1]
        pad = k // ratio - 1
        pad_left = pad * ratio + (k - ratio) // 2
        pad_right = pad * ratio + (k - ratio + 1) // 2
        xc = F.pad(x.transpose(1, 2), (pad, pad), mode="replicate")
        up = ratio * F.conv_transpose1d(
            xc, self.filt_up.expand(c, 1, k), stride=ratio, groups=c)
        up = up[..., pad_left: up.shape[-1] - pad_right]
        up = self.act(up.transpose(1, 2)).transpose(1, 2)
        kd = self.down_kernel
        dn = F.pad(up, (kd // 2 - int(kd % 2 == 0), kd // 2), mode="replicate")
        return F.conv1d(dn, self.filt_dn.expand(c, 1, kd), stride=ratio, groups=c).transpose(1, 2)


class WN(nn.Module):
    """WaveNet gated stack (modules.WN): cond_layer, in_layers, res_skip_layers;
    dropout on the gate's output at `p_dropout` (0 in every codec module, as
    in JAX)."""

    def __init__(self, hidden: int, kernel_size: int, dilation_rate: int, n_layers: int,
                 gin_channels: int = 0, p_dropout: float = 0.0):
        super().__init__()
        self.hidden, self.n_layers = hidden, n_layers
        self.drop = nn.Dropout(p_dropout)
        if gin_channels:
            self.cond_layer = Conv1d(gin_channels, 2 * hidden * n_layers, 1,
                                     padding=(0, 0), weight_norm=True)
        self.in_layers = nn.ModuleList(
            Conv1d(hidden, 2 * hidden, kernel_size, dilation=dilation_rate ** i,
                   weight_norm=True) for i in range(n_layers))
        self.res_skip_layers = nn.ModuleList(
            Conv1d(hidden, 2 * hidden if i < n_layers - 1 else hidden, 1,
                   padding=(0, 0), weight_norm=True) for i in range(n_layers))

    def forward(self, x, x_mask, g=None):
        h = self.hidden
        output = torch.zeros_like(x)
        if g is not None:
            g_all = self.cond_layer(g[:, None, :] if g.ndim == 2 else g)
        for i in range(self.n_layers):
            x_in = self.in_layers[i](x)
            if g is not None:
                x_in = x_in + g_all[..., i * 2 * h: (i + 1) * 2 * h]
            acts = self.drop(torch.tanh(x_in[..., :h]) * torch.sigmoid(x_in[..., h:]))
            res_skip = self.res_skip_layers[i](acts)
            if i < self.n_layers - 1:
                x = (x + res_skip[..., :h]) * x_mask
                output = output + res_skip[..., h:]
            else:
                output = output + res_skip
        return output * x_mask


class ResBlock1(nn.Module):
    """HiFi-GAN ResBlock1 (modules.ResBlock1): convs1 dilated, convs2 plain."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: Sequence[int] = (1, 3, 5)):
        super().__init__()
        self.convs1 = nn.ModuleList(Conv1d(channels, channels, kernel_size, dilation=d,
                                           weight_norm=True) for d in dilations)
        self.convs2 = nn.ModuleList(Conv1d(channels, channels, kernel_size,
                                           weight_norm=True) for _ in dilations)

    def forward(self, x, x_mask=None):
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = F.leaky_relu(x, LRELU_SLOPE)
            if x_mask is not None:
                xt = xt * x_mask
            xt = F.leaky_relu(c1(xt), LRELU_SLOPE)
            if x_mask is not None:
                xt = xt * x_mask
            x = x + c2(xt)
        if x_mask is not None:
            x = x * x_mask
        return x


class RelPosMultiHeadAttention(nn.Module):
    """Multi-head attention with 1x1 conv projections (attentions.
    MultiHeadAttention, no window), used by MelStyleEncoder as its
    `slf_attn` with Linear projections w_qs, w_ks, w_vs, fc; dropout on the
    probabilities at `p_dropout`."""

    def __init__(self, channels: int, out_channels: int, n_heads: int,
                 qk_scale: Optional[float] = None, p_dropout: float = 0.0):
        super().__init__()
        self.n_heads = n_heads
        self.drop = nn.Dropout(p_dropout)
        dk = channels // n_heads
        self.scale = qk_scale if qk_scale is not None else 1.0 / math.sqrt(dk)
        self.w_qs = Linear(channels, channels)
        self.w_ks = Linear(channels, channels)
        self.w_vs = Linear(channels, channels)
        self.fc = Linear(channels, out_channels)

    def forward(self, x, c, attn_mask=None):
        b, t, d = x.shape
        h = self.n_heads
        q = self.w_qs(x).reshape(b, t, h, -1).transpose(1, 2)
        k = self.w_ks(c).reshape(b, c.shape[1], h, -1).transpose(1, 2)
        v = self.w_vs(c).reshape(b, c.shape[1], h, -1).transpose(1, 2)
        scores = (q * self.scale) @ k.transpose(-1, -2)
        if attn_mask is not None:
            scores = scores.masked_fill(attn_mask == 0, -1e4)
        p = self.drop(torch.softmax(scores, dim=-1))
        return self.fc((p @ v).transpose(1, 2).reshape(b, t, d))


class Conv1dGLU(nn.Module):
    """conv → GLU gate with residual (modules.Conv1dGLU; key conv1.conv);
    dropout on the gated branch only."""

    def __init__(self, channels: int, kernel_size: int, p_dropout: float = 0.0):
        super().__init__()
        self.conv1 = nn.Module()
        self.conv1.conv = Conv1d(channels, 2 * channels, kernel_size)
        self.drop = nn.Dropout(p_dropout)

    def forward(self, x):
        a, b = self.conv1.conv(x).chunk(2, dim=-1)
        return x + self.drop(a * torch.sigmoid(b))


class _FC(nn.Module):
    """A `.fc` Linear holder (the reference's LinearNorm wrapper)."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.fc = Linear(d_in, d_out)

    def forward(self, x):
        return self.fc(x)


class MelStyleEncoder(nn.Module):
    """Spectral MLP → Conv1dGLU x2 → self-attention → masked temporal mean
    (modules.MelStyleEncoder). (B, T, n_mel) → (B, style_vector_dim). Dropout
    at `p_dropout` (0.1, the JAX package's fixed rate) after each spectral
    layer, in the gates and on the attention probabilities."""

    def __init__(self, n_mel_channels: int = 80, style_hidden: int = 128,
                 style_vector_dim: int = 256, style_kernel_size: int = 5,
                 style_head: int = 2, p_dropout: float = 0.1):
        super().__init__()
        self.spectral = nn.ModuleDict({"0": _FC(n_mel_channels, style_hidden),
                                       "3": _FC(style_hidden, style_hidden)})
        self.temporal = nn.ModuleList(Conv1dGLU(style_hidden, style_kernel_size, p_dropout)
                                      for _ in range(2))
        self.slf_attn = RelPosMultiHeadAttention(style_hidden, style_hidden, style_head,
                                                 qk_scale=style_hidden ** -0.5,
                                                 p_dropout=p_dropout)
        self.fc = _FC(style_hidden, style_vector_dim)
        self.drop = nn.Dropout(p_dropout)

    def forward(self, x, mask=None):
        x = self.drop(mish(self.spectral["0"](x)))
        x = self.drop(mish(self.spectral["3"](x)))
        for m in self.temporal:
            x = m(x)
        attn_mask = None
        if mask is not None:
            x = x * mask
            attn_mask = mask[:, None, :, 0][:, :, None, :] * mask[:, None, :, 0][:, :, :, None]
        x = x + self.slf_attn(x, x, attn_mask)
        x = self.fc(x)
        if mask is None:
            return x.mean(dim=1)
        return (x * mask).sum(dim=1) / mask.sum(dim=1).clamp_min(1.0)


# ---------------------------------------------------------------------------
# VITS relative-position transformer (attentions.py, ttts_tpu blocks.py:290-440)
# ---------------------------------------------------------------------------


class MultiHeadAttention(nn.Module):
    """Self or cross attention with 1x1 conv projections and an optional
    windowed relative-position bias (attentions.MultiHeadAttention; ttts_tpu
    RelPosMultiHeadAttention with window_size). Keys conv_q, conv_k, conv_v,
    conv_o, emb_rel_k, emb_rel_v; the heads share one (1, 2w+1, dk) table
    each, as every configuration does. Masked scores are -1e4, as in JAX.
    `proximal_bias` adds -log1p(|i - j|) to the scores of a self-attention
    (attentions.py _attention_bias_proximal, FFT's); `qk_scale` replaces the
    1/sqrt(dk) score scale. A causal or cross mask comes in as attn_mask.
    Plain PyTorch: the JAX package computes it outside any Pallas kernel, at
    widths (192 wide, 2 heads) too small to want one. Dropout on the
    probabilities at `p_dropout`."""

    def __init__(self, channels: int, out_channels: int, n_heads: int,
                 window_size: Optional[int] = None, p_dropout: float = 0.0,
                 proximal_bias: bool = False, qk_scale: Optional[float] = None):
        super().__init__()
        self.n_heads, self.window_size = n_heads, window_size
        self.proximal_bias = proximal_bias
        self.drop = nn.Dropout(p_dropout)
        self.dk = dk = channels // n_heads
        self.scale = qk_scale if qk_scale is not None else 1.0 / math.sqrt(dk)
        self.conv_q, self.conv_k, self.conv_v = (
            Conv1d(channels, channels, 1, padding=(0, 0)) for _ in range(3))
        self.conv_o = Conv1d(channels, out_channels, 1, padding=(0, 0))
        if window_size is not None:
            self.emb_rel_k = nn.Parameter(torch.randn(1, 2 * window_size + 1, dk) * dk ** -0.5)
            self.emb_rel_v = nn.Parameter(torch.randn(1, 2 * window_size + 1, dk) * dk ** -0.5)


class ConvFFN(nn.Module):
    """conv → ReLU → dropout → conv, masked (attentions.FFN; keys conv_1,
    conv_2); `causal` pads k - 1 frames on the left only."""

    def __init__(self, channels: int, out_channels: int, filter_channels: int,
                 kernel_size: int, p_dropout: float = 0.0, causal: bool = False):
        super().__init__()
        pad = (kernel_size - 1, 0) if causal else None
        self.conv_1 = Conv1d(channels, filter_channels, kernel_size, padding=pad)
        self.conv_2 = Conv1d(filter_channels, out_channels, kernel_size, padding=pad)
        self.drop = nn.Dropout(p_dropout)


class TransformerEncoder(nn.Module):
    """Post-LN transformer with windowed relative-position self-attention
    (attentions.Encoder; keys attn_layers, norm_layers_1, ffn_layers,
    norm_layers_2); dropout at `p_dropout` on the attention probabilities,
    inside the FFN and on both branches before their residual adds."""

    def __init__(self, hidden_channels: int, filter_channels: int, n_heads: int,
                 n_layers: int, kernel_size: int = 1, window_size: int = 4,
                 p_dropout: float = 0.0):
        super().__init__()
        hc = hidden_channels
        self.attn_layers = nn.ModuleList(
            MultiHeadAttention(hc, hc, n_heads, window_size=window_size, p_dropout=p_dropout)
            for _ in range(n_layers))
        self.norm_layers_1 = nn.ModuleList(LayerNorm(hc) for _ in range(n_layers))
        self.ffn_layers = nn.ModuleList(ConvFFN(hc, hc, filter_channels, kernel_size,
                                                p_dropout) for _ in range(n_layers))
        self.norm_layers_2 = nn.ModuleList(LayerNorm(hc) for _ in range(n_layers))
        self.drop = nn.Dropout(p_dropout)


