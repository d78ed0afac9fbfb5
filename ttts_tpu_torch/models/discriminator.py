"""GAN discriminators of the codec, port of ttts_tpu/models/discriminator.py
(reference ttts/vqvae/vq2.py:418-552): MultiPeriodDiscriminator =
DiscriminatorS + DiscriminatorP for each period (2, 3, 5, 7, 11).

Inputs are waveforms (B, T, 1), channels-last, as in JAX. DiscriminatorP
reflect-pads time to a multiple of its period, folds it into (B, 1, T/p, p)
and runs NCHW conv2d with (k, 1) kernels. Every convolution is weight-normed
as flax nn.WeightNorm is: g * v / sqrt(||v||^2 + 1e-12), the norm over
every axis but the output features (weight_g (out, 1, ...), weight_v the
kernel). Keys are the reference's: discriminators.{i}.convs.{j},
discriminators.{i}.conv_post. Plain PyTorch (cuDNN), f32: the JAX package
runs them outside any Pallas kernel.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ttts_tpu_torch.models.blocks import LRELU_SLOPE, Conv1d


class _Conv2dK1(nn.Module):
    """A weight-normed (k, 1) Conv2d on NCHW."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int, pad: int):
        super().__init__()
        w = torch.empty(out_ch, in_ch, k, 1)
        nn.init.kaiming_uniform_(w, a=math.sqrt(5))
        self.weight_v = nn.Parameter(w)
        self.weight_g = nn.Parameter(w.square().sum(dim=(1, 2, 3), keepdim=True).sqrt())
        bound = 1.0 / math.sqrt(in_ch * k)
        self.bias = nn.Parameter(torch.empty(out_ch).uniform_(-bound, bound))
        self.stride, self.pad = stride, pad

    def forward(self, x):
        v = self.weight_v
        w = v * torch.rsqrt((v * v).sum(dim=(1, 2, 3), keepdim=True) + 1e-12) * self.weight_g
        return F.conv2d(x, w, self.bias, stride=(self.stride, 1), padding=(self.pad, 0))


class DiscriminatorP(nn.Module):
    """Period discriminator (vq2.py:418-497): → (scores (B, n), feature maps
    (B, C, T', p) each)."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3,
                 channels: Sequence[int] = (32, 128, 512, 1024)):
        super().__init__()
        self.period = period
        kp = (kernel_size - 1) // 2
        chans = [1, *channels]
        self.convs = nn.ModuleList(
            _Conv2dK1(chans[i], chans[i + 1], kernel_size, stride, kp)
            for i in range(len(channels)))
        self.convs.append(_Conv2dK1(chans[-1], chans[-1], kernel_size, 1, kp))
        self.conv_post = _Conv2dK1(chans[-1], 1, 3, 1, 1)

    def forward(self, x) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        b, t, _ = x.shape
        p = self.period
        x = x.transpose(1, 2)  # (B, 1, T)
        if t % p:
            x = F.pad(x, (0, p - t % p), mode="reflect")
        x = x.reshape(b, 1, x.shape[-1] // p, p)
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(b, -1), fmap


S_SPECS = ((16, 15, 1, 1), (64, 41, 4, 4), (256, 41, 4, 16), (1024, 41, 4, 64),
           (1024, 41, 4, 256), (1024, 5, 1, 1))  # (channels, kernel, stride, groups)


class DiscriminatorS(nn.Module):
    """Scale discriminator (vq2.py:497-525) on (B, T, 1): → (scores (B, n),
    feature maps (B, T', C) each)."""

    def __init__(self, specs: Sequence[Tuple[int, int, int, int]] = S_SPECS):
        super().__init__()
        chans = [1] + [s[0] for s in specs]
        self.convs = nn.ModuleList(
            Conv1d(chans[i], ch, k, stride=s, groups=g, padding=((k - 1) // 2, (k - 1) // 2),
                   weight_norm=True)
            for i, (ch, k, s, g) in enumerate(specs))
        self.conv_post = Conv1d(chans[-1], 1, 3, weight_norm=True)

    def forward(self, x):
        b = x.shape[0]
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(b, -1), fmap


class MultiPeriodDiscriminator(nn.Module):
    """DiscriminatorS + DiscriminatorP of each period (vq2.py:527-552):
    (y, y_hat) → (scores_real, scores_gen, fmaps_real, fmaps_gen)."""

    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11),
                 p_channels: Sequence[int] = (32, 128, 512, 1024),
                 s_specs: Sequence[Tuple[int, int, int, int]] = S_SPECS):
        super().__init__()
        self.discriminators = nn.ModuleList(
            [DiscriminatorS(s_specs)] + [DiscriminatorP(p, channels=p_channels)
                                         for p in periods])

    def forward(self, y, y_hat):
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        for d in self.discriminators:
            s_r, f_r = d(y)
            s_g, f_g = d(y_hat)
            y_d_rs.append(s_r)
            y_d_gs.append(s_g)
            fmap_rs.append(f_r)
            fmap_gs.append(f_g)
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs
