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
Channels-last. The training forward (`train=True`) adds the
classifier-free dropout (`uncond`: rows whose code embedding becomes the
unconditioned one, and whose mel prediction is zeroed) and layer drop
(`layer_keep`: one bool per trunk layer), each injected or drawn from a
torch.Generator (`training_draws`), as JAX draws them from its "uncond"
and "layerdrop" keys; dropout in the resblocks acts in train mode
(`module.train()`). Under autograd every kernel dispatch takes its plain
version.

Key names follow the reference module's attributes (`code_converter`,
`latent_conditioner`, `contextual_embedder`, `mel_head`, and the trunk's);
no released checkpoint was checked against them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ttts_tpu_torch.models.blocks import Conv1d, same_pad
from ttts_tpu_torch.models.diffusion_net import (AttentionBlock, DiffusionTrunk, GroupNorm32,
                                                 nearest_interp)


class DiffusionTts(DiffusionTrunk):
    def __init__(self, model_channels: int = 512, num_layers: int = 8, in_channels: int = 100,
                 in_latent_channels: int = 512, in_tokens: int = 8193, out_channels: int = 200,
                 num_heads: int = 16, dropout: float = 0.0, layer_drop: float = 0.1,
                 unconditioned_percentage: float = 0.1):
        ch = model_channels
        super().__init__(ch, in_channels, out_channels, num_heads, num_layers, dropout)
        self.layer_drop, self.unconditioned_percentage = layer_drop, unconditioned_percentage
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

    def training_draws(self, b: int, generator: Optional[torch.Generator] = None):
        """One training forward's draws: (uncond (B,) bool, each row with
        probability unconditioned_percentage, or None at 0; layer_keep, one
        bool per trunk layer, each kept with probability 1 - layer_drop, or
        None at 0)."""
        uncond = keep = None
        if self.unconditioned_percentage > 0:
            uncond = torch.rand(b, generator=generator) < self.unconditioned_percentage
        if self.layer_drop > 0:
            keep = (torch.rand(len(self.layers), generator=generator) >= self.layer_drop).tolist()
        return uncond, keep

    def timestep_independent(self, aligned_conditioning, conditioning_latent,
                             expected_seq_len: int, return_code_pred: bool = False,
                             uncond: Optional[torch.Tensor] = None):
        """aligned_conditioning: codes (B, L) int or a latent (B, L,
        in_latent) float; conditioning_latent: get_conditioning's (B, 2 ch),
        or a conditioning mel (B, T, in_channels) that goes through it. →
        the code embedding at expected_seq_len frames (B, T, ch) f32 [, the
        mel_head's prediction (B, T, in_channels)]. `uncond` (B,) bool: rows
        whose embedding becomes the unconditioned one and whose prediction
        is zero (training's classifier-free dropout)."""
        if conditioning_latent.ndim > 2:
            conditioning_latent = self.get_conditioning(conditioning_latent)
        scale, shift = conditioning_latent.float().chunk(2, dim=1)
        if aligned_conditioning.is_floating_point():
            code_emb = self.latent_conditioner(aligned_conditioning)
        else:
            code_emb = self.code_converter(self.code_embedding(aligned_conditioning))
        code_emb = self.code_norm(code_emb) * (1 + scale[:, None]) + shift[:, None]
        if uncond is not None:
            rows = uncond.to(code_emb.device)[:, None, None]
            code_emb = torch.where(rows, self.unconditioned(*code_emb.shape[:2]), code_emb)
        expanded = nearest_interp(code_emb, expected_seq_len)
        if not return_code_pred:
            return expanded
        mel_pred = self.mel_head(expanded).float()
        if uncond is not None:
            mel_pred = mel_pred * ~rows
        return expanded, mel_pred

    def forward(self, x, timesteps, aligned_conditioning=None, conditioning_latent=None,
                precomputed_aligned_embeddings=None, conditioning_free: bool = False,
                return_code_pred: bool = False, train: bool = False,
                uncond: Optional[torch.Tensor] = None, layer_keep=None,
                generator: Optional[torch.Generator] = None):
        """x (B, T, in_channels) noisy mel, timesteps (B,) → (B, T,
        out_channels) f32 [, mel_pred: None when conditioning_free or
        precomputed_aligned_embeddings, as in the JAX module]. With `train`
        the classifier-free dropout and layer drop act: `uncond` and
        `layer_keep` (see training_draws) replace the draws from
        `generator`."""
        mel_pred = None
        b, t = x.shape[:2]
        if train:
            drawn = self.training_draws(b, generator)
            uncond = drawn[0] if uncond is None else uncond
            layer_keep = drawn[1] if layer_keep is None else layer_keep
        else:
            uncond = layer_keep = None
        if conditioning_free:
            code_emb = self.unconditioned(b, t)
        elif precomputed_aligned_embeddings is not None:
            code_emb = precomputed_aligned_embeddings
        elif return_code_pred:
            code_emb, mel_pred = self.timestep_independent(
                aligned_conditioning, conditioning_latent, t, True, uncond)
        else:
            code_emb = self.timestep_independent(aligned_conditioning, conditioning_latent, t,
                                                 uncond=uncond)
        out = self.trunk(x, timesteps, code_emb, layer_keep=layer_keep)
        return (out, mel_pred) if return_code_pred else out
