"""RVQ1, the codec of the reference's released pipeline, port of
ttts_tpu/models/rvq1.py (reference ttts/vqvae/rvq1.py:234-373, the model
that infer_utils.load_model('vqvae') builds and whose extract_code writes
the `.vq` sidecars):

  spec ─ ref_enc (stride-2 conv + perceiver RefEncoder) → ge
       ─ semantic_enc (spec → HuBERT space, L1-distilled)
       ─ stride-2 semantic_proj → RVQ (n_q 1, 1024 codes of D = 1024)
       ─ 2x nearest upsample → text_enc (AttentionBlocks + MRTE over 256
         learned latents) → (m_p, logs_p)
  spec ─ spec_enc posterior → z ─ flow → z_p; the HiFi-GAN dec on z slices.

Channels-last, state-dict keys the reference's (ttts_tpu/models/porting.py
port_rvq1_state reads them). The quantizer's nearest-code search goes
through models/quantize.nearest, so on the card it runs the VQ kernel at
D = hubert_channels. The AttentionBlocks are the diffusion trunk's, in f32,
where `attention.attend` takes its plain version, as JAX builds them
without its Pallas attention.

The stride-2 content path gives ceil(T/2) codes and 2 * ceil(T/2) upsampled
frames: for an odd T that is T + 1 frames against spec_enc's T, as in JAX,
which returns the mismatched shapes without raising; so does this port.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ttts_tpu_torch.models.blocks import WN, Conv1d
from ttts_tpu_torch.models.diffusion_net import AttentionBlock, Conv1x1, CrossAttention
from ttts_tpu_torch.models.diffusion_net import RefEncoder as DiffusionRefEncoder
from ttts_tpu_torch.models.vqvae import (Generator, ResidualCouplingBlock, ResidualVQ,
                                         rand_slice_segments)


class RefEncoder(DiffusionRefEncoder):
    """Perceiver pooling over the spec embedding (rvq1.py:20-45): the
    diffusion trunk's RefEncoder with 16 latents, 16 heads and two
    AttentionBlocks at out_dim, averaged over the whole latents ++ x
    sequence (the reference's slice indexes channels with the latent width,
    a no-op). (B, T, ref_dim) → (B, out_dim)."""

    def __init__(self, ref_dim: int, out_dim: int, num_latents: int = 16,
                 num_heads: int = 16):
        super().__init__(ref_dim, num_latents, num_heads, out_dim=out_dim, num_blocks=2)


class MRTE1(nn.Module):
    """Latent-memory MRTE (rvq1.py:47-83): the content gives the queries, the
    latent bank (through mel_enc) the keys and values, so the output keeps
    the content's length; plus the style ge (ge_enc) and text_pre's content.
    Keys ge_enc.0, mel_enc.0, text_pre.0, cross_attention.conv_*, c_post."""

    def __init__(self, model_channels: int = 512, semantic_channels: int = 1024,
                 gin_channels: int = 512, num_heads: int = 16, latent_channels: int = 512,
                 content_channels: int = 512):
        super().__init__()
        mc = model_channels
        self.ge_enc = nn.Sequential(Conv1x1(gin_channels, mc))
        self.mel_enc = nn.Sequential(Conv1d(latent_channels, mc, 3))
        self.text_pre = nn.Sequential(Conv1d(content_channels, mc, 1, padding=(0, 0)))
        self.cross_attention = CrossAttention(mc, num_heads)
        self.c_post = Conv1d(mc, semantic_channels, 1, padding=(0, 0))

    def forward(self, latents, content, ge):
        geh = self.ge_enc(ge)[:, None, :]
        mel = self.mel_enc(latents)
        txt = self.text_pre(content)
        x = self.cross_attention(txt, mel) + txt + geh
        return self.c_post(x)


class RVQ1TextEncoder(nn.Module):
    """Quantized-content prior with a 256-latent memory (rvq1.py:84-123):
    conv + N AttentionBlocks (enc1) → MRTE1 (the content queries the latent
    bank) → N AttentionBlocks (enc2) → proj. → (h, m, logs), the content's
    length."""

    def __init__(self, in_channels: int, dim: int = 768, out_channels: int = 192,
                 gin_channels: int = 512, num_layers: int = 3, num_heads: int = 16,
                 num_latents: int = 256):
        super().__init__()
        self.enc1 = nn.Sequential(Conv1d(in_channels, dim, 3),
                                  *(AttentionBlock(dim, num_heads) for _ in range(num_layers)))
        self.latents = nn.Parameter(torch.randn(num_latents, dim) * 0.02)
        self.mrte = MRTE1(dim, dim, gin_channels, 16, latent_channels=dim, content_channels=dim)
        self.enc2 = nn.Sequential(*(AttentionBlock(dim, num_heads) for _ in range(num_layers)))
        self.proj = Conv1d(dim, 2 * out_channels, 1, padding=(0, 0))

    def forward(self, x, ge):
        h = self.enc1(x)
        lat = self.latents[None].expand(x.shape[0], -1, -1)
        h = self.enc2(self.mrte(lat, h, ge))
        m, logs = self.proj(h).chunk(2, dim=-1)
        return h, m, logs


class WNEncoder(nn.Module):
    """1x1 in_proj → WN → proj (SemanticEncoder / SpecEncoder,
    rvq1.py:125-188); the style g enters the WN detached, as JAX stops its
    gradient. `posterior`: (z, m, logs) with z = m + noise * exp(logs)
    (`noise` the shape of m; z = m without it), else the projection."""

    def __init__(self, in_channels: int, out_channels: int, hidden_channels: int,
                 kernel_size: int = 5, dilation_rate: int = 1, num_layers: int = 16,
                 gin_channels: int = 0, posterior: bool = False):
        super().__init__()
        self.posterior = posterior
        self.in_proj = Conv1d(in_channels, hidden_channels, 1, padding=(0, 0))
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, num_layers, gin_channels)
        self.proj = Conv1d(hidden_channels, out_channels * (2 if posterior else 1), 1,
                           padding=(0, 0))

    def forward(self, x, g=None, noise: Optional[torch.Tensor] = None):
        mask = torch.ones_like(x[..., :1])
        h = self.enc(self.in_proj(x), mask, g=None if g is None else g.detach())
        if not self.posterior:
            return self.proj(h)
        m, logs = self.proj(h).chunk(2, dim=-1)
        z = m if noise is None else m + noise * torch.exp(logs)
        return z, m, logs


class RVQ1(nn.Module):
    """The codec: spec (B, T, spec_channels) channels-last; `forward` the
    training forward, `infer`, `decode` and `extract_code` as JAX's. The
    quantizer starts waiting for its k-means init (rvq_init), as JAX's init
    leaves it; a loaded state dict brings the trained codebook."""

    def __init__(self, spec_channels: int = 1025, hubert_channels: int = 1024,
                 inter_channels: int = 192, dim: int = 192,
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 3,
                 upsample_rates: Sequence[int] = (10, 8, 2, 2, 2),
                 upsample_initial_channel: int = 512,
                 upsample_kernel_sizes: Sequence[int] = (16, 16, 8, 2, 2),
                 gin_channels: int = 512, segment_frames: int = 32, codebook_bins: int = 1024):
        super().__init__()
        self.segment_frames = segment_frames
        self.semantic_proj = Conv1d(hubert_channels, hubert_channels, 3, stride=2,
                                    padding=(1, 1))
        self.text_enc = RVQ1TextEncoder(hubert_channels, 768, inter_channels, gin_channels, 3, 16)
        self.semantic_enc = WNEncoder(spec_channels, hubert_channels, dim,
                                      gin_channels=gin_channels)
        self.spec_enc = WNEncoder(spec_channels, inter_channels, dim, gin_channels=gin_channels,
                                  posterior=True)
        self.dec = Generator(inter_channels, resblock_kernel_sizes, resblock_dilation_sizes,
                             upsample_rates, upsample_initial_channel, upsample_kernel_sizes,
                             gin_channels=gin_channels)
        self.flow = ResidualCouplingBlock(inter_channels, dim, 5, 1, 4,
                                          gin_channels=gin_channels)
        self.ref_enc = nn.Sequential(Conv1d(spec_channels, 1024, 3, stride=2, padding=(1, 1)),
                                     RefEncoder(1024, gin_channels))
        self.quantizer = ResidualVQ(hubert_channels, 1, codebook_bins, kmeans_pending=True)

    def _quantized_content(self, spec, ge, train: bool, vq_draws=None,
                           generator: Optional[torch.Generator] = None):
        """semantic_enc → semantic_proj → the quantizer (its training
        forward when `train`) → 2x nearest upsample: (semantic, quantized
        (B, 2 ceil(T/2), H), codes (1, B, ceil(T/2)), commit loss)."""
        semantic = self.semantic_enc(spec, g=ge)
        sem_down = self.semantic_proj(semantic)
        if train:
            quantized, codes, commit = self.quantizer.forward_train(sem_down, vq_draws, generator)
        else:
            quantized, codes = self.quantizer(sem_down)
            commit = torch.zeros((), device=spec.device)
        return semantic, quantized.repeat_interleave(2, dim=1), codes, commit

    def forward(self, spec, hubert, train: bool = True, noise: Optional[torch.Tensor] = None,
                ids_slice: Optional[torch.Tensor] = None, vq_draws=None,
                generator: Optional[torch.Generator] = None):
        """The training forward (rvq1.py:305-332): spec (B, T, spec_channels),
        hubert (B, T, hubert_channels) the distillation target → (y_hat (B,
        segment_frames * 640, 1), commit loss, ids_slice (B,), (z, z_p, m_p,
        logs_p, m_q, logs_q), quantized, semantic loss). With `train` the
        codebook takes its EMA / k-means update, spec_enc samples z and the
        decoder takes random slices: `noise` (the shape of m_q), `ids_slice`
        and `vq_draws` (quantize.vq_draws) replace the draws from
        `generator`. Without it: no update, z = m_q, the first slice."""
        ge = self.ref_enc(spec)
        semantic, quantized, _, commit = self._quantized_content(spec, ge, train, vq_draws,
                                                                 generator)
        semantic_loss = torch.mean(torch.abs(hubert.detach() - semantic))
        _, m_p, logs_p = self.text_enc(quantized, ge)
        if train and noise is None:
            dev = spec.device if generator is None else generator.device
            noise = torch.randn(spec.shape[:2] + m_p.shape[2:], generator=generator,
                                device=dev).to(spec.device)
        z, m_q, logs_q = self.spec_enc(spec, g=ge, noise=noise if train else None)
        z_p = self.flow(z, torch.ones_like(z[..., :1]), g=ge)
        if train:
            lengths = torch.full((z.shape[0],), z.shape[1], device=z.device)
            z_slice, ids_slice = rand_slice_segments(z, lengths, self.segment_frames, ids_slice,
                                                     generator)
        else:
            z_slice = z[:, :self.segment_frames]
            ids_slice = torch.zeros(z.shape[0], dtype=torch.long, device=z.device)
        o = self.dec(z_slice, g=ge)
        return o, commit, ids_slice, (z, z_p, m_p, logs_p, m_q, logs_q), quantized, semantic_loss

    def _synthesize(self, quantized, ge, noise_scale: float, noise, generator):
        """text_enc → z_p = m_p + noise * exp(logs_p) * noise_scale → the
        flow's reverse pass → dec. `noise` (the shape of m_p) is drawn from
        `generator` when None."""
        _, m_p, logs_p = self.text_enc(quantized, ge)
        if noise is None:
            dev = m_p.device if generator is None else generator.device
            noise = torch.randn(m_p.shape, generator=generator, device=dev).to(m_p.device)
        z_p = m_p + noise * torch.exp(logs_p) * noise_scale
        z = self.flow(z_p, torch.ones_like(z_p[..., :1]), g=ge, reverse=True)
        return self.dec(z, g=ge)

    def infer(self, spec, noise_scale: float = 0.5, noise: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None):
        """spec (B, T, spec_channels) → wav (B, 2 ceil(T/2) * 640, 1)."""
        ge = self.ref_enc(spec)
        _, quantized, _, _ = self._quantized_content(spec, ge, train=False)
        return self._synthesize(quantized, ge, noise_scale, noise, generator)

    def decode(self, codes, refer_spec, noise_scale: float = 0.5,
               noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
        """codes (n_q, B, L) + a reference spec (B, Tr, spec_channels) → wav
        (B, 2 L * 640, 1) (the intended semantics of rvq1.py:353-366)."""
        ge = self.ref_enc(refer_spec)
        quantized = self.quantizer.decode(codes).repeat_interleave(2, dim=1)
        return self._synthesize(quantized, ge, noise_scale, noise, generator)

    def extract_code(self, spec) -> torch.Tensor:
        """spec → codes (B, n_q, ceil(T/2)) (rvq1.py:368-373, the `.vq` sidecars)."""
        ge = self.ref_enc(spec)
        _, _, codes, _ = self._quantized_content(spec, ge, train=False)
        return codes.transpose(0, 1)

