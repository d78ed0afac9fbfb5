"""AA_diffusion, port of ttts_tpu/models/diffusion_net.py: the latent- and
reference-conditioned mel denoiser. Tensors are channels-last (B, T, C);
state-dict keys are the reference's (ttts/diffusion/aa_model.py).

Every AttentionBlock takes its T5-bucket relative-position bias as the
(H, 2T-1) Toeplitz strip and runs the Toeplitz-bias attention kernel; every
ScaleShiftResBlock runs the fused resblock kernel (ops/cuda), each through
its op's dispatch (`attention.attend`, `resblock.scale_shift_resblock`),
which takes the plain version for shapes and dtypes outside the kernel's
domain, as the JAX package gates its kernels; here every dispatch is the
plain version. Matmuls compute in their weights' dtype, GroupNorms in f32.
The benchmark runs the sampler's path in inference: `timestep_independent`
and `trunk`.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.config import DiffusionNetConfig
from portbench.reference.blocks import Conv1d, Linear
from portbench.reference.plain import attention, resblock

TACOTRON_MEL_MAX = 5.5451774444795624753378569716654


def normalize_tacotron_mel(mel):
    """v2 scale-only normalization (aa_model.py:14-23)."""
    return mel.clamp_min(-TACOTRON_MEL_MAX) * 0.18215


def denormalize_tacotron_mel(norm_mel):
    return norm_mel / 0.18215


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0):
    """Sinusoidal embedding, cos first; fractional timesteps allowed."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    return F.pad(emb, (0, 1)) if dim % 2 else emb


def num_groups(channels: int) -> int:
    groups = 32 if channels > 64 else (16 if channels > 16 else 8)
    while channels % groups:
        groups //= 2
    return groups


def nearest_interp(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """F.interpolate(mode='nearest') along time of (B, T, C)."""
    idx = torch.arange(out_len, device=x.device) * x.shape[1] // out_len
    return x[:, idx]


class GroupNorm32(nn.GroupNorm):
    """GroupNorm over (B, T, C) channels-last, computed (and returned) in f32."""

    def __init__(self, channels: int):
        super().__init__(num_groups(channels), channels, eps=1e-5)

    def forward(self, x):
        y = F.group_norm(x.float().transpose(1, 2), self.num_groups,
                         self.weight.float(), self.bias.float(), self.eps)
        return y.transpose(1, 2)


def _relaid(owner: nn.Module, weights, fn):
    """fn(*weights): a kernel's layout of `owner`'s weights, computed again
    only when a weight's storage or version changes, not on every call."""
    key = tuple((w.data_ptr(), w._version) for w in weights)
    if key != getattr(owner, "_layout_key", None):
        owner._layout, owner._layout_key = fn(*weights), key
    return owner._layout


class Conv1x1(nn.Module):
    """A kernel-size-1 Conv1d (weight (out, in, 1)) applied as a linear map."""

    def __init__(self, d_in: int, d_out: int, zero: bool = False):
        super().__init__()
        bound = 1.0 / math.sqrt(d_in)
        self.weight = nn.Parameter(torch.empty(d_out, d_in, 1).uniform_(-bound, bound))
        self.bias = nn.Parameter(torch.empty(d_out).uniform_(-bound, bound))
        if zero:
            nn.init.zeros_(self.weight)
            nn.init.zeros_(self.bias)

    def forward(self, x):
        w = self.weight
        return F.linear(x.to(w.dtype), w[:, :, 0], self.bias.to(w.dtype))


def _t5_bucket(rel_pos: np.ndarray, num_buckets: int = 32, max_distance: int = 64):
    """Symmetric T5 relative-position bucketing (xtransformers.py:156-175)."""
    n = -rel_pos
    num_buckets //= 2
    ret = (n < 0).astype(np.int64) * num_buckets
    n = np.abs(n)
    max_exact = num_buckets // 2
    val_if_large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact) / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)).astype(np.int64)
    val_if_large = np.minimum(val_if_large, num_buckets - 1)
    return ret + np.where(n < max_exact, n, val_if_large)


class RelativePositionBias(nn.Module):
    """T5-bucket relative-position bias; Toeplitz, so only its (H, 2T-1)
    diagonal strip is ever built."""

    def __init__(self, heads: int, scale: float, num_buckets: int = 32,
                 max_distance: int = 64):
        super().__init__()
        self.scale, self.num_buckets, self.max_distance = scale, num_buckets, max_distance
        self.relative_attention_bias = nn.Embedding(num_buckets, heads)

    def strip(self, t: int) -> torch.Tensor:
        """bias[h, i, j] = strip[h, j-i+t-1]."""
        buckets = _t5_bucket(np.arange(-(t - 1), t), self.num_buckets, self.max_distance)
        w = self.relative_attention_bias.weight
        idx = torch.from_numpy(buckets).to(w.device)
        # F.embedding, not w[idx]: its backward sums repeated rows in a fixed
        # order, so a training step repeats bit for bit
        return F.embedding(idx, w).t().float() * self.scale


class AttentionBlock(nn.Module):
    """GroupNorm → qkv 1x1 (legacy per-head [q;k;v] channel split) →
    Toeplitz-bias attention → zero-initialised proj_out → residual
    (utils.AttentionBlock:172-215).

    With `relative_pos_embeddings=False` (the
    classifier's and the conditioning encoder's blocks) there is no bias:
    the attention takes the kernel's no-bias mode."""

    def __init__(self, channels: int, num_heads: int = 1, relative_pos_embeddings: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.norm = GroupNorm32(channels)
        self.qkv = Conv1x1(channels, 3 * channels)
        self.proj_out = Conv1x1(channels, channels, zero=True)
        if relative_pos_embeddings:
            self.relative_pos_embeddings = RelativePositionBias(
                num_heads, scale=(channels // num_heads) ** 0.5)
        else:
            self.relative_pos_embeddings = None

    def forward(self, x, strip: Optional[torch.Tensor] = None):
        b, t, c = x.shape
        h = self.num_heads
        dk = c // h
        qkv = self.qkv(self.norm(x)).reshape(b, t, h, 3 * dk)
        q, k, v = qkv[..., :dk], qkv[..., dk:2 * dk], qkv[..., 2 * dk:]
        if strip is None and self.relative_pos_embeddings is not None:
            strip = self.relative_pos_embeddings.strip(t)
        a = attention.attend(q, k, v, strip)
        return x + self.proj_out(a.reshape(b, t, c))


class ScaleShiftResBlock(nn.Module):
    """ResBlock with scale-shift (FiLM) timestep conditioning, efficient 1x1
    in-conv (aa_model.py:72-133); runs as one fused resblock call
    (resblock.scale_shift_resblock)."""

    def __init__(self, channels: int, emb_channels: int, dropout: float = 0.0):
        super().__init__()
        self.in_layers = nn.Sequential(GroupNorm32(channels), nn.SiLU(),
                                       Conv1x1(channels, channels))
        self.emb_layers = nn.Sequential(nn.SiLU(), Linear(emb_channels, 2 * channels))
        self.out_layers = nn.Sequential(GroupNorm32(channels), nn.SiLU(), nn.Dropout(dropout),
                                        Conv1d(channels, channels, 3))

    def forward(self, x, emb):
        scale, shift = self.emb_layers(emb).float().chunk(2, dim=-1)
        gn1, gn2 = self.in_layers[0], self.out_layers[0]
        a2 = gn2.weight.float() * (1 + scale)
        b2 = gn2.bias.float() * (1 + scale) + shift
        # w1 (in, out) and w3 (tap, in, out), the kernel's layouts
        w1, w3 = _relaid(self, (self.in_layers[2].weight, self.out_layers[3].weight),
                        lambda w1, w3: (w1[:, :, 0].t().contiguous(),
                                        w3.permute(2, 1, 0).contiguous()))
        return resblock.scale_shift_resblock(
            x.to(w1.dtype), gn1.weight, gn1.bias, w1, self.in_layers[2].bias, a2, b2,
            w3, self.out_layers[3].bias, groups=gn1.num_groups)


class DiffusionLayer(nn.Module):
    """ScaleShiftResBlock + AttentionBlock (aa_model.py:135-148)."""

    def __init__(self, channels: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.resblk = ScaleShiftResBlock(channels, channels, dropout)
        self.attn = AttentionBlock(channels, num_heads)

    def forward(self, x, time_emb, strip=None):
        return self.attn(self.resblk(x, time_emb), strip)


class CrossAttention(nn.Module):
    """Multi-head attention of queries q_in (B, Tq, dim) over kv_in (B, Tk,
    dim) through 1x1 conv projections conv_q, conv_k, conv_v, conv_o, the
    softmax in f32 (the perceiver pools' and RVQ1's MRTE1's)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.conv_q, self.conv_k, self.conv_v, self.conv_o = (Conv1x1(dim, dim)
                                                              for _ in range(4))

    def forward(self, q_in, kv_in):
        b, tq, dim = q_in.shape
        h, dk = self.num_heads, dim // self.num_heads
        q = self.conv_q(q_in).reshape(b, tq, h, dk).transpose(1, 2)
        k = self.conv_k(kv_in).reshape(b, -1, h, dk).transpose(1, 2)
        v = self.conv_v(kv_in).reshape(b, -1, h, dk).transpose(1, 2)
        w = torch.softmax(((q / math.sqrt(dk)) @ k.transpose(-1, -2)).float(), dim=-1)
        return self.conv_o((w.to(v.dtype) @ v).transpose(1, 2).reshape(b, tq, dim))


class RefEncoder(nn.Module):
    """Perceiver pooling: learned latents cross-attend to the sequence, then
    conv (dim → out_dim) + `num_blocks` AttentionBlocks over latents ++ x,
    mean-pooled (aa_model.py:150-178; RVQ1's RefEncoder, rvq1.py:20-45, with
    16 latents, 16 heads, 2 blocks). (B, T, dim) → (B, out_dim)."""

    def __init__(self, dim: int, num_latents: int = 32, num_heads: int = 8,
                 out_dim: Optional[int] = None, num_blocks: int = 4):
        super().__init__()
        out_dim = out_dim or dim
        self.latents = nn.Parameter(torch.randn(num_latents, dim) * 0.02)
        self.cross_attention = CrossAttention(dim, num_heads)
        self.enc = nn.Sequential(Conv1d(dim, out_dim, 3),
                                 *(AttentionBlock(out_dim, num_heads) for _ in range(num_blocks)))

    def forward(self, x):
        lat = self.cross_attention(self.latents[None].expand(x.shape[0], -1, -1), x)
        y = self.enc(torch.cat([lat, x.to(lat.dtype)], dim=1))
        return y.mean(dim=1)


class DiffusionTrunk(nn.Module):
    """The denoiser trunk that AA_diffusion and models.diffusion_tts_v1.
    DiffusionTts share: the timestep embedding, the conditioning-timestep
    integrator (3 DiffusionLayers), the input block, the integrating conv,
    the DiffusionLayers + 3 ScaleShiftResBlocks and GroupNorm → SiLU → conv
    out, under the reference's names."""

    def __init__(self, ch: int, in_channels: int, out_channels: int, num_heads: int,
                 num_layers: int, dropout: float = 0.0):
        super().__init__()
        self.channels = ch
        self.inp_block = Conv1d(in_channels, ch, 3)
        self.time_embed = nn.Sequential(Linear(ch, ch), nn.SiLU(), Linear(ch, ch))
        self.unconditioned_embedding = nn.Parameter(torch.randn(1, ch, 1))
        self.conditioning_timestep_integrator = nn.ModuleList(
            DiffusionLayer(ch, num_heads, dropout) for _ in range(3))
        self.integrating_conv = Conv1x1(2 * ch, ch)
        self.layers = nn.ModuleList(
            [DiffusionLayer(ch, num_heads, dropout) for _ in range(num_layers)]
            + [ScaleShiftResBlock(ch, ch, dropout) for _ in range(3)])
        self.out = nn.Sequential(GroupNorm32(ch), nn.SiLU(), Conv1d(ch, out_channels, 3))

    def unconditioned(self, b: int, t: int) -> torch.Tensor:
        """The learned unconditioned embedding tiled to (b, t, ch)."""
        return self.unconditioned_embedding.transpose(1, 2).expand(b, t, -1)

    def _attention_blocks(self):
        return [m.attn for m in self.conditioning_timestep_integrator] + [
            m.attn for m in self.layers if isinstance(m, DiffusionLayer)]

    def rel_biases(self, t_len: int) -> List[torch.Tensor]:
        """Per-attention (H, 2T-1) bias strips of the trunk, built once per
        sampling run rather than per step."""
        return [a.relative_pos_embeddings.strip(t_len) for a in self._attention_blocks()]

    def trunk(self, x, timesteps, cond_emb, rel_biases=None, layer_keep=None):
        """Noisy mel (B, T, in) + conditioning (B, T, ch) → (B, T, out) f32.
        layer_keep: one bool per trunk layer, or None (keep all); layers 0 <
        i < n-1 with a False keep are skipped (stochastic depth,
        aa_model.py:274-279; JAX's where(keep, y, x) on the whole batch)."""
        strips = iter(rel_biases if rel_biases is not None else self.rel_biases(x.shape[1]))
        t_emb = self.time_embed(timestep_embedding(timesteps, self.channels))
        h = cond_emb
        for m in self.conditioning_timestep_integrator:
            h = m(h, t_emb, next(strips))
        x = self.inp_block(x)
        x = self.integrating_conv(torch.cat([x, h.to(x.dtype)], dim=-1))
        n = len(self.layers)
        for i, lyr in enumerate(self.layers):
            strip = next(strips) if isinstance(lyr, DiffusionLayer) else None
            if layer_keep is not None and 0 < i < n - 1 and not layer_keep[i]:
                continue
            x = lyr(x, t_emb, strip) if isinstance(lyr, DiffusionLayer) else lyr(x, t_emb)
        return self.out(x).float()


class AA_diffusion(DiffusionTrunk):
    def __init__(self, cfg: DiffusionNetConfig):
        ch = cfg.model_channels
        super().__init__(ch, cfg.in_channels, cfg.out_channels, cfg.num_heads, cfg.num_layers,
                         cfg.dropout)
        self.cfg = c = cfg
        self.code_norm = GroupNorm32(ch)
        self.latent_conditioner = nn.Sequential(
            Conv1d(c.in_latent_channels, ch, 3),
            *(AttentionBlock(ch, c.num_heads) for _ in range(3)))
        self.refer_enc = nn.Sequential(
            Conv1d(c.in_channels, ch, 3),
            *(AttentionBlock(ch, c.num_heads) for _ in range(3)), RefEncoder(ch))

    def timestep_independent(self, latent, refer, expected_seq_len: int, uncond=None):
        """latent (B, Tl, in_latent), refer (B, Tr, in_channels) → conditioning
        (B, expected_seq_len, ch) (aa_model.py:245-257). uncond: (B,) bool,
        rows whose conditioning becomes the unconditioned embedding
        (training's classifier-free dropout), or None."""
        latent_emb = self.latent_conditioner(latent)
        refer_emb = self.refer_enc(refer)
        latent_emb = self.code_norm(latent_emb) + refer_emb.float()[:, None, :]
        if uncond is not None:
            u = self.unconditioned(*latent_emb.shape[:2]).to(latent_emb.dtype)
            latent_emb = torch.where(uncond[:, None, None], u, latent_emb)
        return nearest_interp(latent_emb, expected_seq_len)

