"""The Tortoise discrete VAE, port of ttts_tpu/models/dvae.py (reference
ttts/vqvae/dvae.py DiscreteVAE:208-400, the 1-D mel variant): stride-2 conv
encoder → EMA vector quantization → transposed-conv decoder. Channels-last
mel (B, T, channels).

Keys follow the reference's Sequential layout: encoder.{i}.0 the strided
convs (each with its ReLU), encoder.{L + j} the ResBlocks (net.0, net.2),
then the 1x1 conv to the codebook width; decoder.0 the 1x1 conv and
decoder.{1 + j} the ResBlocks when there are ResBlocks, then the transposed
convs and the 1x1 output conv. The codebook is the port's ResidualVQ
(quantizer.vq.layers.0._codebook.*), JAX's replacement of the reference's
Quantize. Its nearest-code search goes through models/quantize.nearest, so
on the card it runs the VQ kernel (D = codebook_dim, 512 by default)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ttts_tpu_torch.models.blocks import Conv1d, ConvTranspose1d
from ttts_tpu_torch.models.vqvae import ResidualVQ


class ResBlock(nn.Module):
    """ReLU(x + conv3(ReLU(conv3(x)))), JAX's _ResBlock (keys net.0, net.2)."""

    def __init__(self, channels: int):
        super().__init__()
        self.net = nn.Sequential(Conv1d(channels, channels, 3), nn.ReLU(),
                                 Conv1d(channels, channels, 3))

    def forward(self, x):
        return torch.relu(x + self.net(x))


class DiscreteVAE(nn.Module):
    def __init__(self, num_tokens: int = 512, codebook_dim: int = 512, channels: int = 80,
                 out_channels: int = 80, hidden_dim: int = 64, num_layers: int = 3,
                 num_resnet_blocks: int = 0, kernel_size: int = 4, stride: int = 2):
        super().__init__()
        pad = (kernel_size - 1) // 2
        ch = [hidden_dim * 2 ** i for i in range(num_layers)]
        enc, c_in = [], channels
        for c in ch:
            enc.append(nn.Sequential(Conv1d(c_in, c, kernel_size, stride=stride,
                                            padding=(pad, pad)), nn.ReLU()))
            c_in = c
        enc += [ResBlock(ch[-1]) for _ in range(num_resnet_blocks)]
        enc.append(Conv1d(ch[-1], codebook_dim, 1, padding=(0, 0)))
        self.encoder = nn.Sequential(*enc)
        dec, c_in = [], codebook_dim
        if num_resnet_blocks:
            dec.append(Conv1d(codebook_dim, ch[-1], 1, padding=(0, 0)))
            dec += [ResBlock(ch[-1]) for _ in range(num_resnet_blocks)]
            c_in = ch[-1]
        for c in reversed(ch):
            dec.append(nn.Sequential(ConvTranspose1d(c_in, c, kernel_size, stride, pad),
                                     nn.ReLU()))
            c_in = c
        dec.append(Conv1d(ch[0], out_channels, 1, padding=(0, 0)))
        self.decoder = nn.Sequential(*dec)
        self.quantizer = ResidualVQ(codebook_dim, 1, num_tokens, kmeans_pending=True)

    def forward(self, mel, train: bool = False, vq_draws=None,
                generator: Optional[torch.Generator] = None):
        """mel (B, T, channels) → (recon loss, commit loss, recon (B, T', out)).
        With `train` the codebook takes its EMA / k-means update (its draws
        `vq_draws`, or from `generator`); without it the eval search."""
        h = self.encoder(mel)
        if train:
            q, _, commit = self.quantizer.forward_train(h, vq_draws, generator)
        else:
            q, _ = self.quantizer(h)
            commit = torch.zeros((), device=mel.device)
        out = self.decoder(q)
        t = min(out.shape[1], mel.shape[1])
        return torch.mean((out[:, :t] - mel[:, :t]) ** 2), commit, out

    def get_codebook_indices(self, mel) -> torch.Tensor:
        """mel (B, T, channels) → codes (B, T / stride^num_layers)."""
        return self.quantizer.encode(self.encoder(mel))[0]

    def decode_codes(self, codes) -> torch.Tensor:
        """codes (B, L) → mel (B, L * stride^num_layers, out_channels)."""
        return self.decoder(self.quantizer.decode(codes[None]))
