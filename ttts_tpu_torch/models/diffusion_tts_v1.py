"""DiffusionTts, the Tortoise-v1 diffusion decoder, port of ttts_tpu/models/
diffusion_tts_v1.py (reference ttts/diffusion/model.py:134-330): the
AA_diffusion trunk (diffusion_net.DiffusionTrunk: the Toeplitz-bias
attention and resblock kernels) conditioned by
  - VQ codes (code_embedding + 3 AttentionBlocks) or an AR latent
    (latent_conditioner: conv + 4 AttentionBlocks),
  - a conditioning mel through the strided `contextual_embedder` (two
    stride-2 convs with flax "SAME" padding, then 5 AttentionBlocks at 2 ch)
    whose mean splits into a (scale, shift) FiLM pair on the code embedding,
  - a learned unconditioned embedding (conditioning_free),
and an auxiliary `mel_head` predicting the mel from the conditioning.
Channels-last. The inference forward only: layer drop and the
classifier-free dropout are training.

Key names follow the reference module's attributes (`code_converter`,
`latent_conditioner`, `contextual_embedder`, `mel_head`, and the trunk's);
no released checkpoint was checked against them.
"""

from __future__ import annotations

import torch.nn as nn

from ttts_tpu_torch.models.blocks import Conv1d, same_pad
from ttts_tpu_torch.models.diffusion_net import (AttentionBlock, DiffusionTrunk, GroupNorm32,
                                                 nearest_interp)


class DiffusionTts(DiffusionTrunk):
    def __init__(self, model_channels: int = 512, num_layers: int = 8, in_channels: int = 100,
                 in_latent_channels: int = 512, in_tokens: int = 8193, out_channels: int = 200,
                 num_heads: int = 16):
        ch = model_channels
        super().__init__(ch, in_channels, out_channels, num_heads, num_layers)
        self.code_embedding = nn.Embedding(in_tokens, ch)
        self.code_converter = nn.Sequential(*(AttentionBlock(ch, num_heads) for _ in range(3)))
        self.code_norm = GroupNorm32(ch)
        self.latent_conditioner = nn.Sequential(
            Conv1d(in_latent_channels, ch, 3), *(AttentionBlock(ch, num_heads) for _ in range(4)))
        self.contextual_embedder = nn.Sequential(
            Conv1d(in_channels, ch, 3, stride=2), Conv1d(ch, 2 * ch, 3, stride=2),
            *(AttentionBlock(2 * ch, num_heads) for _ in range(5)))
        self.mel_head = Conv1d(ch, in_channels, 3)

    def get_conditioning(self, conditioning_mel):
        """Conditioning mel (B, T, in_channels) → (B, 2 * model_channels), the
        contextual embedder's mean over time."""
        h = conditioning_mel
        for m in self.contextual_embedder:
            h = m(h, same_pad(h.shape[1], 3, 2)) if isinstance(m, Conv1d) else m(h)
        return h.float().mean(dim=1)

    def timestep_independent(self, aligned_conditioning, conditioning_latent,
                             expected_seq_len: int, return_code_pred: bool = False):
        """aligned_conditioning: codes (B, L) int or a latent (B, L,
        in_latent) float; conditioning_latent: get_conditioning's (B, 2 ch),
        or a conditioning mel (B, T, in_channels) that goes through it. →
        the code embedding at expected_seq_len frames (B, T, ch) f32 [, the
        mel_head's prediction (B, T, in_channels)]."""
        if conditioning_latent.ndim > 2:
            conditioning_latent = self.get_conditioning(conditioning_latent)
        scale, shift = conditioning_latent.float().chunk(2, dim=1)
        if aligned_conditioning.is_floating_point():
            code_emb = self.latent_conditioner(aligned_conditioning)
        else:
            code_emb = self.code_converter(self.code_embedding(aligned_conditioning))
        code_emb = self.code_norm(code_emb) * (1 + scale[:, None]) + shift[:, None]
        expanded = nearest_interp(code_emb, expected_seq_len)
        if not return_code_pred:
            return expanded
        return expanded, self.mel_head(expanded).float()

    def forward(self, x, timesteps, aligned_conditioning=None, conditioning_latent=None,
                precomputed_aligned_embeddings=None, conditioning_free: bool = False,
                return_code_pred: bool = False, train: bool = False):
        """x (B, T, in_channels) noisy mel, timesteps (B,) → (B, T,
        out_channels) f32 [, mel_pred: None when conditioning_free or
        precomputed_aligned_embeddings, as in the JAX module]."""
        if train:
            raise NotImplementedError("DiffusionTts: the training forward (layer drop, "
                                      "conditioning dropout) is not ported")
        mel_pred = None
        b, t = x.shape[:2]
        if conditioning_free:
            code_emb = self.unconditioned(b, t)
        elif precomputed_aligned_embeddings is not None:
            code_emb = precomputed_aligned_embeddings
        elif return_code_pred:
            code_emb, mel_pred = self.timestep_independent(
                aligned_conditioning, conditioning_latent, t, True)
        else:
            code_emb = self.timestep_independent(aligned_conditioning, conditioning_latent, t)
        out = self.trunk(x, timesteps, code_emb)
        return (out, mel_pred) if return_code_pred else out
