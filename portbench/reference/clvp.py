"""CLVP, port of ttts_tpu/models/clvp.py: the contrastive text ↔ speech-code
reranker, its x-transformers flavour (`use_xformers=True`, the serving
default) in inference, as the rerank calls it (no masks).

Two encoders, one over BPE text tokens and one over speech codes. Each
layer is RMSNorm → attention (dim_head 64 whatever dim / heads are; rotary
on the first max(dim_head // 2, 32) dims of q, k AND v; biasless q/k/v,
biased out) → residual, then RMSNorm → GLU feed-forward (one 2x-wide
projection, value * GELU(gate), exact GELU) → residual; a final LayerNorm
closes the encoder. Mean pooling, the latent projections, the L2 norm and
exp(temperature) run in f32, and the output is one similarity per (text,
speech) pair. Attention runs the kernels' plain version (`attention.attend`).

Module and parameter names are the reference's (ttts/clvp/model.py with
CheckpointedXTransformerEncoder), so released reference checkpoints load
unchanged.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.config import CLVPConfig
from portbench.reference.blocks import Linear
from portbench.reference.gpt import LayerNorm
from portbench.reference.plain import attention


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


def no_autocast(device: torch.device):
    """Autocast off on `device` (a no-op context where it is not on)."""
    if not torch.is_autocast_enabled(device.type):
        return contextlib.nullcontext()
    return torch.autocast(device.type, enabled=False)


class Attention(nn.Module):
    """Rotary attention through `attention.attend`."""

    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_q = Linear(dim, inner, bias=False)
        self.to_k = Linear(dim, inner, bias=False)
        self.to_v = Linear(dim, inner, bias=False)
        self.to_out = Linear(inner, dim)

    def forward(self, x):
        b, t, _ = x.shape
        h, dk = self.heads, self.dim_head
        rot = max(dk // 2, 32)
        q, k, v = (apply_rotary(f(x).reshape(b, t, h, dk), rot).to(x.dtype)
                   for f in (self.to_q, self.to_k, self.to_v))
        return self.to_out(attention.attend(q, k, v).reshape(b, t, h * dk))


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

    def forward(self, x):
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
            layers.append(nn.ModuleList([nn.ModuleList([RMSNorm(dim)]), _Checkpointed(
                Attention(dim, heads, dim_head))]))
            layers.append(nn.ModuleList([nn.ModuleList([RMSNorm(dim)]),
                                         _Checkpointed(FeedForward(dim))]))
        self.transformer = nn.Module()
        self.transformer.attn_layers = nn.Module()
        self.transformer.attn_layers.layers = nn.ModuleList(layers)
        self.transformer.norm = LayerNorm(dim, eps=1e-5)

    def forward(self, x):
        layers = self.transformer.attn_layers.layers
        x = x.to(layers[0][1].wrap.to_q.weight.dtype)
        for norms, block in layers:
            x = x + block.wrap(norms[0](x))
        return self.transformer.norm(x)


class CLVP(nn.Module):
    def __init__(self, cfg: CLVPConfig):
        super().__init__()
        c = self.cfg = cfg
        self.text_emb = nn.Embedding(c.num_text_tokens, c.dim_text)
        self.speech_emb = nn.Embedding(c.num_speech_tokens, c.dim_speech)
        if not c.use_xformers:
            raise ValueError("the benchmark's reference holds CLVP's x-transformers flavour only")
        self.text_transformer = CLVPEncoder(c.dim_text, c.text_enc_depth, c.text_heads,
                                            c.dim_head)
        self.speech_transformer = CLVPEncoder(c.dim_speech, c.speech_enc_depth,
                                              c.speech_heads, c.dim_head)
        self.to_text_latent = nn.Linear(c.dim_text, c.dim_latent, bias=False)
        self.to_speech_latent = nn.Linear(c.dim_speech, c.dim_latent, bias=False)
        self.temperature = nn.Parameter(torch.tensor(1.0))

    def forward(self, text, speech_tokens):
        """text (B, Lt), speech_tokens (B, Ls) → similarity per pair (B,) f32:
        exp(temperature) * cos(text latent, speech latent)."""
        enc_text = self.text_transformer(self.text_emb(text)).float()
        enc_speech = self.speech_transformer(self.speech_emb(speech_tokens)).float()
        with no_autocast(enc_text.device):
            text_latent = self.to_text_latent(enc_text.mean(dim=1))
            speech_latent = self.to_speech_latent(enc_speech.mean(dim=1))
            text_latent = text_latent / text_latent.norm(dim=-1, keepdim=True)
            speech_latent = speech_latent / speech_latent.norm(dim=-1, keepdim=True)
            return (text_latent * speech_latent).sum(dim=-1) * self.temperature.float().exp()
