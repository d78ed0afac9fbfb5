"""Normalizing flows, port of ttts_tpu/models/flows.py (reference
ttts/vqvae/modules.py:366-937): the VITS flow family beyond the codec's
ResidualCouplingLayer. Log and ElementwiseAffine flows, DDSConv (dilated
depth-separable stack), ConvFlow (piecewise rational-quadratic spline
coupling), ActNorm and InvConvNear (Glow). Channels-last (B, T, C) with
(B, T, 1) masks; forward returns (y, logdet), reverse y alone.

Parameters carry the reference's keys and shapes (ElementwiseAffine m,
logs (C, 1); ActNorm logs, bias (1, C, 1); DDSConv convs_sep, convs_1x1,
norms_1, norms_2; ConvFlow pre, convs, proj; InvConvNear weight). DDSConv
uses JAX's tanh-approximated GELU and LayerNorm epsilon 1e-6."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ttts_tpu_torch.models.blocks import Conv1d, LayerNorm


class LogFlow(nn.Module):
    """y = log(clamp(x, 1e-5)) (modules.Log:366-374)."""

    def forward(self, x, x_mask, reverse: bool = False):
        if reverse:
            return torch.exp(x) * x_mask
        y = torch.log(x.clamp_min(1e-5)) * x_mask
        return y, torch.sum(-y, dim=(1, 2))


class ElementwiseAffine(nn.Module):
    """y = m + exp(logs) x (modules.ElementwiseAffine:387-402)."""

    def __init__(self, channels: int):
        super().__init__()
        self.m = nn.Parameter(torch.zeros(channels, 1))
        self.logs = nn.Parameter(torch.zeros(channels, 1))

    def forward(self, x, x_mask, reverse: bool = False):
        m, logs = self.m[:, 0], self.logs[:, 0]
        if reverse:
            return (x - m) * torch.exp(-logs) * x_mask
        y = (m + torch.exp(logs) * x) * x_mask
        return y, torch.sum(logs * x_mask, dim=(1, 2))


class DDSConv(nn.Module):
    """Dilated depth-separable conv stack (modules.DDSConv:87-133): per layer
    a depthwise conv at dilation k^i → LN → GELU → 1x1 → LN → GELU, added to
    x; dropout at `p_dropout` in train mode."""

    def __init__(self, channels: int, kernel_size: int, n_layers: int, p_dropout: float = 0.0):
        super().__init__()
        self.convs_sep = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, dilation=kernel_size ** i, groups=channels)
            for i in range(n_layers))
        self.convs_1x1 = nn.ModuleList(Conv1d(channels, channels, 1, padding=(0, 0))
                                       for _ in range(n_layers))
        self.norms_1 = nn.ModuleList(LayerNorm(channels) for _ in range(n_layers))
        self.norms_2 = nn.ModuleList(LayerNorm(channels) for _ in range(n_layers))
        self.drop = nn.Dropout(p_dropout)

    def forward(self, x, x_mask, g=None):
        if g is not None:
            x = x + g
        for sep, n1, c1, n2 in zip(self.convs_sep, self.norms_1, self.convs_1x1, self.norms_2):
            y = F.gelu(n1(sep(x * x_mask)), approximate="tanh")
            y = F.gelu(n2(c1(y)), approximate="tanh")
            x = x + self.drop(y)
        return x * x_mask


DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3


def _bins(unnormalized, num_bins: int, minimum: float, tail_bound: float):
    """softmax widths (or heights) → (cumulative edges (..., K+1) from
    -tail_bound to tail_bound, sizes (..., K))."""
    w = minimum + (1 - minimum * num_bins) * torch.softmax(unnormalized, dim=-1)
    cum = F.pad(torch.cumsum(w, dim=-1), (1, 0))
    cum = (2 * tail_bound) * cum - tail_bound
    cum = torch.cat([torch.full_like(cum[..., :1], -tail_bound), cum[..., 1:-1],
                     torch.full_like(cum[..., :1], tail_bound)], dim=-1)
    return cum, cum[..., 1:] - cum[..., :-1]


def rational_quadratic_spline(inputs, unnormalized_widths, unnormalized_heights,
                              unnormalized_derivatives, inverse: bool = False,
                              tail_bound: float = 5.0):
    """The monotone rational-quadratic spline with linear tails (VITS
    transforms.py): identity outside [-tail_bound, tail_bound]. inputs (...);
    widths, heights (..., K); derivatives (..., K - 1). → (outputs,
    log |d outputs / d inputs|)."""
    num_bins = unnormalized_widths.shape[-1]
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    constant = math.log(math.exp(1 - DEFAULT_MIN_DERIVATIVE) - 1)
    ud = F.pad(unnormalized_derivatives, (1, 1), value=constant)
    cumwidths, widths = _bins(unnormalized_widths, num_bins, DEFAULT_MIN_BIN_WIDTH, tail_bound)
    cumheights, heights = _bins(unnormalized_heights, num_bins, DEFAULT_MIN_BIN_HEIGHT,
                                tail_bound)
    derivatives = DEFAULT_MIN_DERIVATIVE + F.softplus(ud)

    x_in = inputs.clamp(-tail_bound, tail_bound)
    edges = cumheights if inverse else cumwidths
    idx = ((x_in[..., None] >= edges[..., :-1]).sum(-1) - 1).clamp(0, num_bins - 1)[..., None]
    take = lambda t: torch.gather(t, -1, idx)[..., 0]  # noqa: E731
    in_cumwidths, in_widths = take(cumwidths[..., :-1]), take(widths)
    in_cumheights, in_heights = take(cumheights[..., :-1]), take(heights)
    delta = in_heights / in_widths
    d0, d1 = take(derivatives[..., :-1]), take(derivatives[..., 1:])

    if inverse:
        a = (x_in - in_cumheights) * (d0 + d1 - 2 * delta) + in_heights * (delta - d0)
        b = in_heights * d0 - (x_in - in_cumheights) * (d0 + d1 - 2 * delta)
        c = -delta * (x_in - in_cumheights)
        root = (2 * c) / (-b - torch.sqrt((b ** 2 - 4 * a * c).clamp_min(0.0)))
        outputs = root * in_widths + in_cumwidths
        tt = root * (1 - root)
        denom = delta + (d0 + d1 - 2 * delta) * tt
        num = delta ** 2 * (d1 * root ** 2 + 2 * delta * tt + d0 * (1 - root) ** 2)
        logabsdet = -(torch.log(num) - 2 * torch.log(denom))
    else:
        theta = (x_in - in_cumwidths) / in_widths
        tt = theta * (1 - theta)
        denom = delta + (d0 + d1 - 2 * delta) * tt
        outputs = in_cumheights + in_heights * (delta * theta ** 2 + d0 * tt) / denom
        num = delta ** 2 * (d1 * theta ** 2 + 2 * delta * tt + d0 * (1 - theta) ** 2)
        logabsdet = torch.log(num) - 2 * torch.log(denom)
    return (torch.where(inside, outputs, inputs),
            torch.where(inside, logabsdet, torch.zeros_like(logabsdet)))


class ConvFlow(nn.Module):
    """Spline coupling layer (modules.ConvFlow:462-537): the first half of
    the channels, through pre → DDSConv → the zero-initialised proj, gives
    the spline of the second half."""

    def __init__(self, in_channels: int, filter_channels: int, kernel_size: int,
                 n_layers: int, num_bins: int = 10, tail_bound: float = 5.0):
        super().__init__()
        self.half, self.num_bins, self.tail_bound = in_channels // 2, num_bins, tail_bound
        self.filter_channels = filter_channels
        self.pre = Conv1d(self.half, filter_channels, 1, padding=(0, 0))
        self.convs = DDSConv(filter_channels, kernel_size, n_layers)
        self.proj = Conv1d(filter_channels, self.half * (3 * num_bins - 1), 1, padding=(0, 0))
        nn.init.zeros_(self.proj.weight)
        nn.init.zeros_(self.proj.bias)

    def forward(self, x, x_mask, g=None, reverse: bool = False):
        x0, x1 = x.chunk(2, dim=-1)
        h = self.proj(self.convs(self.pre(x0), x_mask, g=g)) * x_mask
        b, t, _ = x0.shape
        h = h.reshape(b, t, self.half, 3 * self.num_bins - 1)
        scale = 1.0 / math.sqrt(self.filter_channels)
        nb = self.num_bins
        x1, logabsdet = rational_quadratic_spline(
            x1, h[..., :nb] * scale, h[..., nb:2 * nb] * scale, h[..., 2 * nb:],
            inverse=reverse, tail_bound=self.tail_bound)
        y = torch.cat([x0, x1 * x_mask], dim=-1)
        if reverse:
            return y
        return y, torch.sum(logabsdet * x_mask, dim=(1, 2))


class ActNorm(nn.Module):
    """Per-channel affine (modules.ActNorm:818-867); the data-dependent
    initialisation is the caller's."""

    def __init__(self, channels: int):
        super().__init__()
        self.logs = nn.Parameter(torch.zeros(1, channels, 1))
        self.bias = nn.Parameter(torch.zeros(1, channels, 1))

    def forward(self, x, x_mask=None, reverse: bool = False):
        if x_mask is None:
            x_mask = torch.ones_like(x[..., :1])
        logs, bias = self.logs[0, :, 0], self.bias[0, :, 0]
        if reverse:
            return (x - bias) * torch.exp(-logs) * x_mask
        y = (bias + torch.exp(logs) * x) * x_mask
        return y, torch.sum(logs) * torch.sum(x_mask, dim=(1, 2))


class InvConvNear(nn.Module):
    """Invertible 1x1 conv over groups of n_split channels
    (modules.InvConvNear:869-937), initialised orthogonal with a positive
    determinant."""

    def __init__(self, channels: int, n_split: int = 4):
        super().__init__()
        if channels % n_split:
            raise ValueError(f"{channels} channels in groups of {n_split}")
        self.channels, self.n_split = channels, n_split
        w = torch.linalg.qr(torch.randn(n_split, n_split))[0]
        if torch.det(w) < 0:
            w[:, 0] = -w[:, 0]
        self.weight = nn.Parameter(w)

    def forward(self, x, x_mask: Optional[torch.Tensor] = None, reverse: bool = False):
        b, t, c = x.shape
        ns = self.n_split
        if x_mask is None:
            x_mask = torch.ones_like(x[..., :1])
        # (B, T, C) → (B, T, C // ns, ns), the reference's interleave
        xg = x.reshape(b, t, 2, ns // 2, c // ns).permute(0, 1, 2, 4, 3).reshape(b, t, c // ns, ns)
        w = torch.linalg.inv(self.weight) if reverse else self.weight
        z = torch.einsum("btgs,ks->btgk", xg, w)
        z = z.reshape(b, t, 2, c // ns, ns // 2).permute(0, 1, 2, 4, 3).reshape(b, t, c) * x_mask
        if reverse:
            return z
        logdet = torch.linalg.slogdet(self.weight)[1] * (c / ns) * torch.sum(x_mask, dim=(1, 2))
        return z, logdet
