"""CLVP, port of ttts_tpu/models/clvp.py: the contrastive text ↔ speech-code
reranker, in its x-transformers flavour (`use_xformers=True`, the serving
default, clvp.py:38-141, 206-279). The plain-Transformer flavour is not
ported.

Two encoders, one over BPE text tokens and one over speech codes. Each layer
is RMSNorm → attention (dim_head 64 whatever dim / heads are; rotary on the
first max(dim_head // 2, 32) dims of q, k AND v; biasless q/k/v, biased out)
→ residual, then RMSNorm → GLU feed-forward (one 2x-wide projection,
value * GELU(gate), exact GELU) → residual; a final LayerNorm closes the
encoder. Masked mean pooling, the latent projections, the L2 norm and
exp(temperature) run in f32, and the output is one similarity per (text,
speech) pair.

Unmasked attention (the rerank) runs the flash-attention kernel in its
no-bias mode through `attention.attend`, which takes the plain version
outside the kernel's domain; a call with masks (training only) takes the
masked plain version. Module and parameter names are the reference's
(ttts/clvp/model.py with CheckpointedXTransformerEncoder), so
ttts_tpu.models.porting.port_clvp_xformers_state reads this state dict.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ttts_tpu_torch.config import CLVPConfig
from ttts_tpu_torch.models.blocks import Linear
from ttts_tpu_torch.models.gpt import LayerNorm
from ttts_tpu_torch.ops.cuda import attention


class RMSNorm(nn.Module):
    """x / clamp(‖x‖·dim^-½, 1e-8) · g, statistics in f32, output in x's
    dtype (xtransformers.py:335-343)."""

    def __init__(self, dim: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        x32 = x.float()
        rms = x32.pow(2).mean(dim=-1, keepdim=True).sqrt()
        return (x32 / rms.clamp_min(1e-8) * self.g.float()).to(x.dtype)


def apply_rotary(x: torch.Tensor, rot: int) -> torch.Tensor:
    """Rotary embedding over the first `rot` dims of x (B, T, H, D), the rest
    untouched; f32 out."""
    t = x.shape[1]
    freqs = 1.0 / (10000 ** (torch.arange(0, rot, 2, dtype=torch.float32, device=x.device)
                             / rot))
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * freqs[None]
    ang = torch.cat([ang, ang], dim=-1)[None, :, None]  # (1, T, 1, rot)
    xl, xr = x[..., :rot].float(), x[..., rot:].float()
    x1, x2 = xl.chunk(2, dim=-1)
    return torch.cat([xl * ang.cos() + torch.cat([-x2, x1], dim=-1) * ang.sin(), xr], dim=-1)


def masked_attention(q, k, v, mask):
    """Plain attention with the pair mask q_mask x k_mask filled with
    -finfo.max (xtransformers.py:633-639, 667); q, k, v (B, T, H, D)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(q.shape[-1])
    pair = mask[:, None, :, None] & mask[:, None, None, :]
    s = s.masked_fill(~pair, -torch.finfo(torch.float32).max)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(q.dtype)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_q = Linear(dim, inner, bias=False)
        self.to_k = Linear(dim, inner, bias=False)
        self.to_v = Linear(dim, inner, bias=False)
        self.to_out = Linear(inner, dim)

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        b, t, _ = x.shape
        h, dk = self.heads, self.dim_head
        rot = max(dk // 2, 32)
        q, k, v = (apply_rotary(f(x).reshape(b, t, h, dk), rot).to(x.dtype)
                   for f in (self.to_q, self.to_k, self.to_v))
        a = attention.attend(q, k, v) if mask is None else masked_attention(q, k, v, mask)
        return self.to_out(a.reshape(b, t, h * dk))


class GLU(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.proj = Linear(d_in, 2 * d_out)

    def forward(self, x):
        value, gate = self.proj(x).chunk(2, dim=-1)
        return value * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 2):
        super().__init__()
        # the reference's slots 1 and 2 (post-activation norm, dropout) hold
        # no weights
        self.net = nn.Sequential(GLU(dim, dim * mult), nn.Identity(), nn.Identity(),
                                 Linear(dim * mult, dim))

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        return self.net(x)


class _Checkpointed(nn.Module):
    """The reference's CheckpointedLayer: the block sits under `wrap`."""

    def __init__(self, block: nn.Module):
        super().__init__()
        self.wrap = block


class CLVPEncoder(nn.Module):
    """CheckpointedXTransformerEncoder → ContinuousTransformerWrapper:
    layers[2i] attention, layers[2i+1] feed-forward, each [pre-norm, block],
    then the wrapper's final LayerNorm (f32 out)."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int = 64):
        super().__init__()
        layers = []
        for _ in range(depth):
            layers.append(nn.ModuleList([nn.ModuleList([RMSNorm(dim)]),
                                         _Checkpointed(Attention(dim, heads, dim_head))]))
            layers.append(nn.ModuleList([nn.ModuleList([RMSNorm(dim)]),
                                         _Checkpointed(FeedForward(dim))]))
        self.transformer = nn.Module()
        self.transformer.attn_layers = nn.Module()
        self.transformer.attn_layers.layers = nn.ModuleList(layers)
        self.transformer.norm = LayerNorm(dim, eps=1e-5)

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        layers = self.transformer.attn_layers.layers
        x = x.to(layers[0][1].wrap.to_q.weight.dtype)
        for norms, block in layers:
            x = x + block.wrap(norms[0](x), mask)
        return self.transformer.norm(x)


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, T, D), bool (B, T) or None → (B, D) (clvp/model.py:15-17)."""
    if mask is None:
        return x.mean(dim=1)
    m = mask[..., None].to(x.dtype)
    return (x * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)


class CLVP(nn.Module):
    def __init__(self, cfg: CLVPConfig):
        super().__init__()
        if not cfg.use_xformers:
            raise NotImplementedError("only the x-transformers CLVP flavour is ported")
        c = self.cfg = cfg
        self.text_emb = nn.Embedding(c.num_text_tokens, c.dim_text)
        self.speech_emb = nn.Embedding(c.num_speech_tokens, c.dim_speech)
        self.text_transformer = CLVPEncoder(c.dim_text, c.text_enc_depth, c.text_heads,
                                            c.dim_head)
        self.speech_transformer = CLVPEncoder(c.dim_speech, c.speech_enc_depth,
                                              c.speech_heads, c.dim_head)
        self.to_text_latent = nn.Linear(c.dim_text, c.dim_latent, bias=False)
        self.to_speech_latent = nn.Linear(c.dim_speech, c.dim_latent, bias=False)
        self.temperature = nn.Parameter(torch.tensor(1.0))

    def latents(self, text, speech_tokens, text_mask=None, voice_mask=None):
        """text (B, Lt), speech_tokens (B, Ls) → the unit-norm text and speech
        latents (B, dim_latent) f32."""
        enc_text = self.text_transformer(self.text_emb(text), text_mask).float()
        enc_speech = self.speech_transformer(self.speech_emb(speech_tokens), voice_mask).float()
        text_latent = self.to_text_latent(masked_mean(enc_text, text_mask))
        speech_latent = self.to_speech_latent(masked_mean(enc_speech, voice_mask))
        return (text_latent / text_latent.norm(dim=-1, keepdim=True),
                speech_latent / speech_latent.norm(dim=-1, keepdim=True))

    def forward(self, text, speech_tokens, text_mask=None, voice_mask=None):
        """→ similarity per pair (B,) f32: exp(temperature) * cos(text latent,
        speech latent); see `latents`."""
        text_latent, speech_latent = self.latents(text, speech_tokens, text_mask, voice_mask)
        return (text_latent * speech_latent).sum(dim=-1) * self.temperature.float().exp()
