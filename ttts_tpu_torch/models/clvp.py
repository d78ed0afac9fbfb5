"""CLVP, port of ttts_tpu/models/clvp.py: the contrastive text ↔ speech-code
reranker, in both of its flavours.

Two encoders, one over BPE text tokens and one over speech codes. In the
x-transformers flavour (`use_xformers=True`, the serving default) each layer
is RMSNorm → attention (dim_head 64 whatever dim / heads are; rotary on the
first max(dim_head // 2, 32) dims of q, k AND v; biasless q/k/v, biased out)
→ residual, then RMSNorm → GLU feed-forward (one 2x-wide projection,
value * GELU(gate), exact GELU) → residual; a final LayerNorm closes the
encoder. Masked mean pooling, the latent projections, the L2 norm and
exp(temperature) run in f32, and the output is one similarity per (text,
speech) pair.

Unmasked attention outside training (the rerank) runs the flash-attention
kernel in its no-bias mode through `attention.attend`, which takes the plain
version outside the kernel's domain; a call with masks or in training takes
the masked plain version.

The plain flavour (`use_xformers=False`, the reference v2 trainer's) adds
learned absolute position tables (the speech table vocabulary-sized) and
runs the utils/transformer.py Transformer: per layer LayerScale(PreNorm(
attention)) and LayerScale(PreNorm(GEGLU feed-forward, exact GELU)), layer
scales initialised to 0.1, LayerNorm epsilon 1e-5, keys masked with
-finfo.max, no final norm. Its attention is plain PyTorch in f32, as the
JAX package computes it outside any kernel and always in f32 (the serving
path keeps its weights f32 on the card).

Training (`model.train()`, `return_loss=True`; JAX's train=True): where
text_mask_percentage / voice_mask_percentage > 0, each token is kept where
its uniform draw exceeds the percentage (the draws injected as
`mask_draws`, else torch.rand); the x-transformers flavour's attention
drops probabilities and its feed-forward drops the GLU output at 0.1
(JAX's fixed EncoderLayer dropout; the plain flavour's is 0, as in JAX),
so its attention takes the masked plain version, which computes the
scores, the fill (-finfo(float32).max) and the softmax in f32 whatever
autocast asks, as JAX's does. The plain flavour runs in f32 with autocast
off, as JAX computes it (its fill is then -finfo(float32).max too). The
pooling, latents and the symmetric InfoNCE loss run in f32 with autocast
off. A row whose tokens are all masked pools to zero and its latent is
0/0 (NaN), as in JAX.

Module and parameter names are the reference's (ttts/clvp/model.py with
CheckpointedXTransformerEncoder, or utils/transformer.py), so
ttts_tpu.models.porting.port_clvp_xformers_state / port_clvp_state read
this state dict, and released reference checkpoints load unchanged.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ttts_tpu_torch.config import CLVPConfig
from ttts_tpu_torch.models.blocks import Linear
from ttts_tpu_torch.models.gpt import LayerNorm
from ttts_tpu_torch.ops.cuda import attention
from ttts_tpu_torch.parallel.mesh import data_rank, gather_batch


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


# the x-transformers flavour's attention and feed-forward dropout in training
# mode (JAX's fixed EncoderLayer rate)
DROPOUT = 0.1


def masked_attention(q, k, v, mask: Optional[torch.Tensor], dropout: float = 0.0):
    """Plain attention in f32 (autocast off) with the pair mask q_mask x
    k_mask filled with -finfo(float32).max (xtransformers.py:633-639, 667),
    or no mask (None), and dropout on the probabilities; q, k, v (B, T, H,
    D), out in q's dtype."""
    with no_autocast(q.device):
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(q.shape[-1])
        if mask is not None:
            pair = mask[:, None, :, None] & mask[:, None, None, :]
            s = s.masked_fill(~pair, -torch.finfo(torch.float32).max)
        p = torch.softmax(s, dim=-1).to(q.dtype)
        if dropout > 0:
            p = F.dropout(p, dropout)
        return torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(q.dtype)


class Attention(nn.Module):
    """Rotary attention; with a mask, or with dropout in training mode, the
    masked plain version, else `attention.attend` (the no-bias kernel's
    dispatch)."""

    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads, self.dim_head, self.dropout = heads, dim_head, DROPOUT
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
        dropout = self.dropout if self.training else 0.0
        if mask is None and dropout == 0.0:
            a = attention.attend(q, k, v)
        else:
            a = masked_attention(q, k, v, mask, dropout)
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
        self.net = nn.Sequential(GLU(dim, dim * mult), nn.Identity(), nn.Dropout(DROPOUT),
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
    then the wrapper's final LayerNorm (f32 out); DROPOUT in training
    mode."""

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

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        layers = self.transformer.attn_layers.layers
        x = x.to(layers[0][1].wrap.to_q.weight.dtype)
        for norms, block in layers:
            x = x + block.wrap(norms[0](x), mask)
        return self.transformer.norm(x)


class PlainAttention(nn.Module):
    """utils/transformer.py Attention: one biasless qkv projection, keys
    masked with -finfo.max, biased output projection (`to_out.0`)."""

    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.to_qkv = nn.Linear(dim, 3 * heads * dim_head, bias=False)
        self.to_out = nn.Sequential(nn.Linear(heads * dim_head, dim))

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        b, t, _ = x.shape
        q, k, v = self.to_qkv(x).reshape(b, t, 3, self.heads, self.dim_head).unbind(2)
        s = torch.einsum("bqhd,bkhd->bhqk", q / math.sqrt(self.dim_head), k)
        if mask is not None:
            s = s.masked_fill(~mask[:, None, None, :], -torch.finfo(s.dtype).max)
        a = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
        return self.to_out(a.reshape(b, t, -1))


class PlainFeedForward(nn.Module):
    """Linear → GEGLU (value * GELU(gate), exact GELU) → dropout slot →
    Linear (`net.0`, `net.3`)."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.Sequential(nn.Linear(dim, 2 * dim * mult), nn.Identity(), nn.Identity(),
                                 nn.Linear(dim * mult, dim))

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        value, gate = self.net[0](x).chunk(2, dim=-1)
        return self.net[3](value * F.gelu(gate))


class _PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm, self.fn = nn.LayerNorm(dim, eps=1e-5), fn


class _LayerScale(nn.Module):
    """x + fn.fn(fn.norm(x)) * scale, the scale (1, 1, dim) initialised to 0.1."""

    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.fn = _PreNorm(dim, fn)
        self.scale = nn.Parameter(torch.full((1, 1, dim), 0.1))

    def forward(self, x, mask):
        return x + self.fn.fn(self.fn.norm(x), mask) * self.scale


class PlainEncoder(nn.Module):
    """utils/transformer.py Transformer(causal=False): `layers.layers.{i}` =
    [LayerScale(PreNorm(attention)), LayerScale(PreNorm(feed-forward))], no
    final norm."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int = 64):
        super().__init__()
        self.layers = nn.Module()
        self.layers.layers = nn.ModuleList(
            nn.ModuleList([_LayerScale(dim, PlainAttention(dim, heads, dim_head)),
                           _LayerScale(dim, PlainFeedForward(dim))]) for _ in range(depth))

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        with no_autocast(x.device):
            x = x.float()
            for attn, ff in self.layers.layers:
                x = ff(attn(x, mask), mask)
        return x


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, T, D), bool (B, T) or None → (B, D) (clvp/model.py:15-17)."""
    if mask is None:
        return x.mean(dim=1)
    m = mask[..., None].to(x.dtype)
    return (x * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)


class CLVP(nn.Module):
    def __init__(self, cfg: CLVPConfig):
        super().__init__()
        c = self.cfg = cfg
        self.text_emb = nn.Embedding(c.num_text_tokens, c.dim_text)
        self.speech_emb = nn.Embedding(c.num_speech_tokens, c.dim_speech)
        encoder = CLVPEncoder if c.use_xformers else PlainEncoder
        self.text_transformer = encoder(c.dim_text, c.text_enc_depth, c.text_heads, c.dim_head)
        self.speech_transformer = encoder(c.dim_speech, c.speech_enc_depth, c.speech_heads,
                                          c.dim_head)
        if not c.use_xformers:
            self.text_pos_emb = nn.Embedding(c.text_seq_len, c.dim_text)
            self.speech_pos_emb = nn.Embedding(c.num_speech_tokens, c.dim_speech)
        self.to_text_latent = nn.Linear(c.dim_text, c.dim_latent, bias=False)
        self.to_speech_latent = nn.Linear(c.dim_speech, c.dim_latent, bias=False)
        self.temperature = nn.Parameter(torch.tensor(1.0))

    def latents(self, text, speech_tokens, text_mask=None, voice_mask=None):
        """text (B, Lt), speech_tokens (B, Ls) → the unit-norm text and speech
        latents (B, dim_latent) f32. The plain flavour takes at most
        text_seq_len text and num_speech_tokens speech positions."""
        text_emb, speech_emb = self.text_emb(text), self.speech_emb(speech_tokens)
        if not self.cfg.use_xformers:
            for name, x, table in (("text", text, self.text_pos_emb),
                                   ("speech", speech_tokens, self.speech_pos_emb)):
                if x.shape[1] > table.num_embeddings:
                    raise ValueError(f"CLVP: {x.shape[1]} {name} positions, the table holds "
                                     f"{table.num_embeddings}")
            text_emb = text_emb + self.text_pos_emb.weight[: text.shape[1]]
            speech_emb = speech_emb + self.speech_pos_emb.weight[: speech_tokens.shape[1]]
        enc_text = self.text_transformer(text_emb, text_mask).float()
        enc_speech = self.speech_transformer(speech_emb, voice_mask).float()
        with no_autocast(enc_text.device):
            text_latent = self.to_text_latent(masked_mean(enc_text, text_mask))
            speech_latent = self.to_speech_latent(masked_mean(enc_speech, voice_mask))
        return (text_latent / text_latent.norm(dim=-1, keepdim=True),
                speech_latent / speech_latent.norm(dim=-1, keepdim=True))

    def train_masks(self, text, speech_tokens, text_mask=None, voice_mask=None,
                    mask_draws: Optional[Dict[str, torch.Tensor]] = None):
        """The training masks (clvp/model.py:228-236): where a percentage is
        above 0, a token is kept where its uniform draw (mask_draws["text"]
        (B, Lt) / ["voice"] (B, Ls), else torch.rand) exceeds it, and the
        mask starts all-ones when not given; else the mask is left as given."""
        c = self.cfg
        out = []
        for key, x, mask, pct in (("text", text, text_mask, c.text_mask_percentage),
                                  ("voice", speech_tokens, voice_mask,
                                   c.voice_mask_percentage)):
            if pct > 0:
                u = (mask_draws or {}).get(key)
                if u is None:
                    u = torch.rand(x.shape, device=x.device)
                keep = u.to(x.device) > pct
                mask = keep if mask is None else mask & keep
            out.append(mask)
        return tuple(out)

    def forward(self, text, speech_tokens, text_mask=None, voice_mask=None,
                return_loss: bool = False, mask_draws: Optional[Dict[str, torch.Tensor]] = None,
                mesh=None):
        """→ similarity per pair (B,) f32: exp(temperature) * cos(text latent,
        speech latent); see `latents`. With `return_loss`, the symmetric
        InfoNCE over the batch's pairs (clvp/model.py:137-139), f32; in
        training mode the masks are drawn first (`train_masks`). `mesh`
        (data parallel): the inputs are this rank's rows of the batch; both
        latents are all-gathered through the autograd-aware collective and
        the loss is the mean over this rank's rows of the global (B, B)
        InfoNCE (labels offset by the rank's first row), so the ranks' mean
        is JAX's global loss (clvp.py:281-285)."""
        if self.training:
            text_mask, voice_mask = self.train_masks(text, speech_tokens, text_mask,
                                                     voice_mask, mask_draws)
        text_latent, speech_latent = self.latents(text, speech_tokens, text_mask, voice_mask)
        with no_autocast(text_latent.device):
            temp = self.temperature.float().exp()
            if not return_loss:
                return (text_latent * speech_latent).sum(dim=-1) * temp
            if mesh is None:
                sim = text_latent @ speech_latent.t() * temp
                labels = torch.arange(sim.shape[0], device=sim.device)
                return 0.5 * (F.cross_entropy(sim, labels) + F.cross_entropy(sim.t(), labels))
            b = text_latent.shape[0]
            labels = data_rank(mesh) * b + torch.arange(b, device=text_latent.device)
            speech_all = gather_batch(mesh, speech_latent, autograd=True)
            text_all = gather_batch(mesh, text_latent, autograd=True)
            return 0.5 * (F.cross_entropy(text_latent @ speech_all.t() * temp, labels)
                          + F.cross_entropy(speech_latent @ text_all.t() * temp, labels))
