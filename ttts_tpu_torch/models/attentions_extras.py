"""The rest of the VITS attentions module, port of ttts_tpu/models/
attentions_extras.py (reference ttts/vqvae/attentions.py): the depthwise-
separable convolutions (:439-537), FFT (:558-647, a causal transformer
stack with optional flow conditioning), the flow-conditioned encoder
(attentions.Encoder with isflow) and TransformerCouplingLayer (:648-708).
Nothing in the reference's live graph imports them; they are the surface a
migrating user may call. Channels-last (B, T, C), masks (B, T, 1), keys the
reference's (ttts_tpu/models/porting.py port_fft_state,
port_transformer_coupling_state, port_depthwise_separable_conv_state read
them). Attention is blocks.MultiHeadAttention, plain PyTorch as in JAX."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ttts_tpu_torch.models.blocks import (Conv1d, ConvFFN, LayerNorm, MultiHeadAttention,
                                          TransformerEncoder)


class DepthwiseSeparableConv1d(nn.Module):
    """Depthwise conv (groups = in_channels) → 1x1 pointwise conv (keys
    depth_conv, point_conv), both weight-normed with `weight_norm`."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1, bias: bool = True,
                 weight_norm: bool = False):
        super().__init__()
        self.depth_conv = Conv1d(in_channels, in_channels, kernel_size, stride=stride,
                                 dilation=dilation, padding=(padding, padding), bias=bias,
                                 weight_norm=weight_norm, groups=in_channels)
        self.point_conv = Conv1d(in_channels, out_channels, 1, padding=(0, 0), bias=bias,
                                 weight_norm=weight_norm)

    def forward(self, x):
        return self.point_conv(self.depth_conv(x))


class DepthwiseSeparableConvTranspose1d(nn.Module):
    """Depthwise transposed conv → 1x1 pointwise conv: out_len = (T - 1)
    stride - 2 padding + k. depth_conv's weight is torch's (C, 1, k); with
    `weight_norm` it is weight_v, weight_g (C, 1, 1), one norm per channel
    (the reference's per-input-channel norm is per channel here)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, bias: bool = True, weight_norm: bool = False):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.depth_conv = nn.Module()
        bound = 1.0 / kernel_size ** 0.5
        w = torch.empty(in_channels, 1, kernel_size).uniform_(-bound, bound)
        if weight_norm:
            self.depth_conv.weight_v = nn.Parameter(w)
            self.depth_conv.weight_g = nn.Parameter(w.norm(dim=(1, 2), keepdim=True))
        else:
            self.depth_conv.weight = nn.Parameter(w)
        self.weight_norm = weight_norm
        self.depth_conv.bias = (nn.Parameter(torch.empty(in_channels).uniform_(-bound, bound))
                                if bias else None)
        self.point_conv = Conv1d(in_channels, out_channels, 1, padding=(0, 0), bias=bias,
                                 weight_norm=weight_norm)

    def forward(self, x):
        dc = self.depth_conv
        if self.weight_norm:
            v = dc.weight_v
            w = v * (dc.weight_g / v.norm(dim=(1, 2), keepdim=True).clamp_min(1e-12))
        else:
            w = dc.weight
        y = F.conv_transpose1d(x.transpose(1, 2), w, dc.bias, stride=self.stride,
                               padding=self.padding, groups=w.shape[0])
        return self.point_conv(y.transpose(1, 2))


def _gate(x, cond_pre, g_all, i: int, h: int):
    """The flow conditioning of layer i: tanh * sigmoid of cond_pre(x) plus
    the layer's slice of cond_layer(g)."""
    acts = cond_pre(x) + g_all[..., i * 2 * h:(i + 1) * 2 * h]
    return torch.tanh(acts[..., :h]) * torch.sigmoid(acts[..., h:])


class FFT(nn.Module):
    """Causal transformer stack (attentions.FFT:558-647): per layer, causal
    self-attention (proximal-biased with `proximal_bias`) → LN → causal conv
    FFN → LN; with `isflow` and a g (B, Tg, gin_channels), each layer's input
    first passes the flow gate against a weight-normed cond_layer(g) (keys
    self_attn_layers, norm_layers_0, ffn_layers, norm_layers_1, cond_layer,
    cond_pre). The reference builds its attentions with proximal_init:
    fft_tie_proximal_init ties a fresh model the same way."""

    def __init__(self, hidden_channels: int, filter_channels: int, n_heads: int,
                 n_layers: int = 1, kernel_size: int = 1, p_dropout: float = 0.0,
                 proximal_bias: bool = False, isflow: bool = False, gin_channels: int = 0):
        super().__init__()
        hc = self.hidden_channels = hidden_channels
        self.n_layers = n_layers
        if isflow:
            self.cond_layer = Conv1d(gin_channels, 2 * hc * n_layers, 1, padding=(0, 0),
                                     weight_norm=True)
            self.cond_pre = Conv1d(hc, 2 * hc, 1, padding=(0, 0))
        self.self_attn_layers = nn.ModuleList(
            MultiHeadAttention(hc, hc, n_heads, p_dropout=p_dropout, proximal_bias=proximal_bias)
            for _ in range(n_layers))
        self.norm_layers_0 = nn.ModuleList(LayerNorm(hc) for _ in range(n_layers))
        self.ffn_layers = nn.ModuleList(ConvFFN(hc, hc, filter_channels, kernel_size, p_dropout,
                                                causal=True) for _ in range(n_layers))
        self.norm_layers_1 = nn.ModuleList(LayerNorm(hc) for _ in range(n_layers))
        self.drop = nn.Dropout(p_dropout)

    def forward(self, x, x_mask, g=None):
        h = self.hidden_channels
        t = x.shape[1]
        causal = torch.ones(t, t, device=x.device).tril()[None, None]
        if g is not None:
            if not hasattr(self, "cond_layer"):
                raise ValueError("FFT: conditioning needs isflow=True")
            g_all = self.cond_layer(g)
        x = x * x_mask
        for i in range(self.n_layers):
            if g is not None:
                x = _gate(x, self.cond_pre, g_all, i, h)
            y = self.self_attn_layers[i](x, x, causal)
            x = self.norm_layers_0[i](x + self.drop(y))
            y = self.ffn_layers[i](x, x_mask)
            x = self.norm_layers_1[i](x + self.drop(y))
        return x * x_mask


class FlowConditionedEncoder(TransformerEncoder):
    """attentions.Encoder with isflow (attentions.py:10-89): the windowed
    transformer encoder, each layer's input first through the flow gate
    against a weight-normed cond_layer(g) (keys cond_layer, cond_pre and
    TransformerEncoder's)."""

    def __init__(self, hidden_channels: int, filter_channels: int, n_heads: int,
                 n_layers: int, kernel_size: int = 1, p_dropout: float = 0.0,
                 window_size: int = 4, gin_channels: int = 0):
        super().__init__(hidden_channels, filter_channels, n_heads, n_layers, kernel_size,
                         window_size, p_dropout)
        hc = self.hidden_channels = hidden_channels
        self.cond_layer = Conv1d(gin_channels, 2 * hc * n_layers, 1, padding=(0, 0),
                                 weight_norm=True)
        self.cond_pre = Conv1d(hc, 2 * hc, 1, padding=(0, 0))

    def forward(self, x, x_mask, g=None):
        h = self.hidden_channels
        attn_mask = x_mask[:, None, :, 0][:, :, None, :] * x_mask[:, None, :, 0][:, :, :, None]
        x = x * x_mask
        g_all = None if g is None else self.cond_layer(g)
        for i, (attn, norm1, ffn, norm2) in enumerate(zip(
                self.attn_layers, self.norm_layers_1, self.ffn_layers, self.norm_layers_2)):
            if g_all is not None:
                x = _gate(x, self.cond_pre, g_all, i, h)
            x = norm1(x + self.drop(attn(x, x, attn_mask)))
            x = norm2(x + self.drop(ffn(x, x_mask)))
        return x * x_mask


class TransformerCouplingLayer(nn.Module):
    """Affine coupling whose statistics network is a flow-conditioned
    transformer (attentions.TransformerCouplingLayer:648-708): the first half
    of the channels through pre → enc → the zero-initialised post gives (m,
    logs) of the second. Forward → (y, logdet); reverse → y."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int, n_layers: int,
                 n_heads: int, p_dropout: float = 0.0, filter_channels: int = 0,
                 mean_only: bool = False, gin_channels: int = 0):
        super().__init__()
        self.half, self.mean_only = channels // 2, mean_only
        self.pre = Conv1d(self.half, hidden_channels, 1, padding=(0, 0))
        self.enc = FlowConditionedEncoder(hidden_channels, filter_channels, n_heads, n_layers,
                                          kernel_size, p_dropout, gin_channels=gin_channels)
        self.post = Conv1d(hidden_channels, self.half * (2 - mean_only), 1, padding=(0, 0))
        nn.init.zeros_(self.post.weight)
        nn.init.zeros_(self.post.bias)

    def forward(self, x, x_mask, g=None, reverse: bool = False):
        x0, x1 = x[..., :self.half], x[..., self.half:]
        h = self.enc(self.pre(x0) * x_mask, x_mask, g=g)
        stats = self.post(h) * x_mask
        if self.mean_only:
            m, logs = stats, torch.zeros_like(stats)
        else:
            m, logs = stats[..., :self.half], stats[..., self.half:]
        if reverse:
            return torch.cat([x0, (x1 - m) * torch.exp(-logs) * x_mask], dim=-1)
        x1 = (m + x1 * torch.exp(logs)) * x_mask
        return torch.cat([x0, x1], dim=-1), torch.sum(logs, dim=(1, 2))


@torch.no_grad()
def tie_proximal_init(mha: MultiHeadAttention) -> MultiHeadAttention:
    """attentions.MultiHeadAttention's proximal_init (:306-310): conv_k
    takes conv_q's weight and bias. In place; returns `mha`."""
    mha.conv_k.load_state_dict(mha.conv_q.state_dict())
    return mha


def fft_tie_proximal_init(fft: FFT) -> FFT:
    """proximal_init on every self-attention of `fft`, as the reference's FFT
    builds them (attentions.py:648). In place; returns `fft`."""
    for mha in fft.self_attn_layers:
        tie_proximal_init(mha)
    return fft
