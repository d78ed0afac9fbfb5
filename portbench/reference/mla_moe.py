"""The MLA-MoE speech LM in plain f32 PyTorch: UnifiedVoice's embeddings,
position tables, final_norm and heads around a trunk of the published
`deepseek_v3` decoder layers (Moonlight-16B-A3B's config.json), under the
serving model's state-dict keys.

Each layer, as the published modelling computes it:
  h = x + MLA(RMSNorm(x)); y = h + FFN(RMSNorm(h));
  MLA in the full form: q = W_q x (heads of nope + rope dims), [c; k_pe] =
  W_kva x, c normed, [k_nope; v] = W_kvb c per head, RoPE on q_pe and k_pe
  (pairs de-interleaved, then rotate-half), k_pe shared by the heads,
  softmax((q_nope.k_nope + q_pe.k_pe) / sqrt(nope + rope)) causal, W_o;
  FFN: a dense SwiGLU before first_k_dense_replace, after it sigmoid
  scores in f32, the top k of scores + e_score_correction_bias, weights the
  chosen scores over their sum (+ 1e-20) times routed_scaling_factor, each
  token's k experts gathered expert by expert (the modelling's moe_infer),
  plus the shared SwiGLU.
No cache and no kernels: every position comes from one causal forward over
the whole sequence, which a decode through a cache has to agree with.

Routing near-ties: `routes` (per layer, a (B, T, k) choice of the program
or None) lets a layer take another side's choice where it differs from its
own only among experts whose choice scores lie within `band` of its own
boundary between the k-th and (k+1)-th (the sides' rounding can swap
them); elsewhere the layer keeps its own choice. `tally` counts the
positions where a choice differed, where it was taken and the largest
distance from the boundary of an expert in dispute. `record`, a list,
receives each layer's own choice (B, T, k), None for a dense layer.

The trunk's layers come from `make_layer(i)`, so a caller can make each
layer's weights at its turn and drop them after (the benchmark's check at
the published widths); by default they are built and held here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.gpt import LayerNorm

# the published keys the block reads
KEYS = ("hidden_size", "intermediate_size", "moe_intermediate_size", "num_hidden_layers",
        "num_attention_heads", "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim",
        "v_head_dim", "rope_theta", "rms_norm_eps", "n_routed_experts", "n_shared_experts",
        "num_experts_per_tok", "routed_scaling_factor", "norm_topk_prob",
        "first_k_dense_replace", "max_position_embeddings")


@dataclass(frozen=True)
class Config:
    hidden_size: int
    intermediate_size: int
    moe_intermediate_size: int
    num_hidden_layers: int
    num_attention_heads: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    rope_theta: float
    rms_norm_eps: float
    n_routed_experts: int
    n_shared_experts: int
    num_experts_per_tok: int
    routed_scaling_factor: float
    norm_topk_prob: bool
    first_k_dense_replace: int
    max_position_embeddings: int

    @classmethod
    def of(cls, published: dict) -> "Config":
        return cls(**{k: published[k] for k in KEYS})


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x):
        x = x.float()
        return self.weight * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps))


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, T, [H,] d) at positions 0..T-1: pairs de-interleaved, then
    x cos + rotate_half(x) sin with the frequencies repeated twice."""
    b, t, d = x.shape[0], x.shape[1], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    freqs = torch.outer(torch.arange(t, dtype=torch.float32, device=x.device), inv)
    emb = torch.cat([freqs, freqs], dim=-1)
    shape = (t,) + (1,) * (x.dim() - 3) + (d,)
    cos, sin = emb.cos().reshape(shape), emb.sin().reshape(shape)
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    rot = torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)
    return x * cos + rot * sin


class Attention(nn.Module):
    def __init__(self, c: Config):
        super().__init__()
        self.c = c
        h, d = c.num_attention_heads, c.hidden_size
        self.q_proj = nn.Linear(d, h * (c.qk_nope_head_dim + c.qk_rope_head_dim), bias=False)
        self.kv_a_proj_with_mqa = nn.Linear(d, c.kv_lora_rank + c.qk_rope_head_dim, bias=False)
        self.kv_a_layernorm = RMSNorm(c.kv_lora_rank, c.rms_norm_eps)
        self.kv_b_proj = nn.Linear(c.kv_lora_rank, h * (c.qk_nope_head_dim + c.v_head_dim),
                                   bias=False)
        self.o_proj = nn.Linear(h * c.v_head_dim, d, bias=False)

    def forward(self, x):
        c = self.c
        b, t, _ = x.shape
        h, nope, r = c.num_attention_heads, c.qk_nope_head_dim, c.qk_rope_head_dim
        q = self.q_proj(x).view(b, t, h, nope + r)
        latent, k_pe = self.kv_a_proj_with_mqa(x).split([c.kv_lora_rank, r], dim=-1)
        kv = self.kv_b_proj(self.kv_a_layernorm(latent)).view(b, t, h, nope + c.v_head_dim)
        k_nope, v = kv.split([nope, c.v_head_dim], dim=-1)
        q = torch.cat([q[..., :nope], rope(q[..., nope:], c.rope_theta)], dim=-1)
        k = torch.cat([k_nope, rope(k_pe, c.rope_theta)[:, :, None].expand(b, t, h, r)], dim=-1)
        s = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(nope + r)
        keep = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
        return self.o_proj(torch.einsum("bhts,bshd->bthd", p, v).reshape(b, t, -1))


class MLP(nn.Module):
    def __init__(self, d: int, f: int):
        super().__init__()
        self.gate_proj = nn.Linear(d, f, bias=False)
        self.up_proj = nn.Linear(d, f, bias=False)
        self.down_proj = nn.Linear(f, d, bias=False)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Gate(nn.Module):
    def __init__(self, c: Config):
        super().__init__()
        self.c = c
        self.weight = nn.Parameter(torch.zeros(c.n_routed_experts, c.hidden_size))
        self.e_score_correction_bias = nn.Parameter(torch.zeros(c.n_routed_experts))

    def forward(self, x, routes=None, band: float = 0.0, tally: Optional[dict] = None,
                record: Optional[list] = None):
        """x (N, D) → (chosen (N, k), weights (N, k)); see the module
        docstring for `routes`, `band`, `tally` and `record`."""
        c, k = self.c, self.c.num_experts_per_tok
        s = torch.sigmoid(x.float() @ self.weight.t())
        choice = s + self.e_score_correction_bias
        top = choice.topk(k + 1, dim=-1)
        own = top.indices[:, :k]
        if record is not None:
            record.append(own)
        idx = own
        if routes is not None:
            routes = routes.reshape(-1, k).long()
            mine = torch.zeros_like(choice, dtype=torch.bool).scatter_(1, own, True)
            theirs = torch.zeros_like(mine).scatter_(1, routes, True)
            kth, next_ = top.values[:, k - 1: k], top.values[:, k: k + 1]
            far = torch.maximum(
                torch.where(theirs & ~mine, kth - choice, -math.inf).amax(1),
                torch.where(mine & ~theirs, choice - next_, -math.inf).amax(1))
            differ = (mine != theirs).any(1)
            take = differ & (far <= band)
            idx = torch.where(take[:, None], routes, own)
            if tally is not None:
                tally["route_differ"] = tally.get("route_differ", 0) + int(differ.sum())
                tally["route_taken"] = tally.get("route_taken", 0) + int(take.sum())
                if bool(differ.any()):
                    tally["route_gap"] = max(tally.get("route_gap", 0.0),
                                             float(far[differ].max()))
        w = s.gather(1, idx)
        if c.norm_topk_prob:
            w = w / (w.sum(-1, keepdim=True) + 1e-20)
        return idx, w * c.routed_scaling_factor


class MoE(nn.Module):
    def __init__(self, c: Config):
        super().__init__()
        self.c = c
        self.gate = Gate(c)
        self.experts = nn.ModuleList(MLP(c.hidden_size, c.moe_intermediate_size)
                                     for _ in range(c.n_routed_experts))
        self.shared_experts = MLP(c.hidden_size, c.moe_intermediate_size * c.n_shared_experts)

    def forward(self, x, routes=None, band: float = 0.0, tally=None, record=None):
        b, t, d = x.shape
        x2 = x.reshape(b * t, d)
        own = [] if record is not None else None
        idx, w = self.gate(x2, routes, band, tally, own)
        if record is not None:
            record.append(own[0].view(b, t, -1))
        y = torch.zeros_like(x2)
        for e, expert in enumerate(self.experts):
            token, slot = (idx == e).nonzero(as_tuple=True)
            if token.numel():
                y.index_add_(0, token, w[token, slot, None] * expert(x2[token]))
        return (y + self.shared_experts(x2)).view(b, t, d)


class Block(nn.Module):
    def __init__(self, c: Config, layer: int):
        super().__init__()
        self.routed = layer >= c.first_k_dense_replace
        self.input_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps)
        self.self_attn = Attention(c)
        self.post_attention_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps)
        self.mlp = MoE(c) if self.routed else MLP(c.hidden_size, c.intermediate_size)

    def forward(self, x, routes=None, band: float = 0.0, tally=None, record=None):
        x = x + self.self_attn(self.input_layernorm(x))
        xn = self.post_attention_layernorm(x)
        if self.routed:
            return x + self.mlp(xn, routes, band, tally, record)
        if record is not None:
            record.append(None)
        return x + self.mlp(xn)


class UnifiedVoiceLM(nn.Module):
    """UnifiedVoice (portbench/reference/gpt.py's embeddings, tables, norms
    and heads) around the MLA-MoE trunk: gpt.h.{i} the layers (made by
    `make_layer` when given, else held here), gpt.ln_f an RMSNorm.
    `routes` (phase → per-layer choices or None), `band`, `tally`, `record`:
    see the module docstring; the phases are "decode" (decode_logits) and
    "latent" (forward)."""

    def __init__(self, gpt_cfg, cfg: Config, make_layer: Optional[Callable[[int], Block]] = None,
                 mel_length_compression: int = 1024):
        super().__init__()
        g = self.gcfg = gpt_cfg
        self.cfg = cfg
        self.mel_length_compression = mel_length_compression
        d = g.model_dim
        self.text_embedding = nn.Embedding(g.number_text_tokens + 1, d)
        self.mel_embedding = nn.Embedding(g.number_mel_codes, d)
        self.text_pos_embedding = nn.Module()
        self.text_pos_embedding.emb = nn.Embedding(g.max_text_tokens + 2, d)
        self.mel_pos_embedding = nn.Module()
        self.mel_pos_embedding.emb = nn.Embedding(g.max_mel_tokens + 2, d)
        self.gpt = nn.Module()
        if make_layer is None:
            self.gpt.h = nn.ModuleList(Block(cfg, i) for i in range(cfg.num_hidden_layers))
        self.gpt.ln_f = RMSNorm(d, cfg.rms_norm_eps)
        self.final_norm = LayerNorm(d, eps=1e-5)
        self.text_head = nn.Linear(d, g.number_text_tokens + 1)
        self.mel_head = nn.Linear(d, g.number_mel_codes)
        self.make_layer = make_layer
        self.routes: Optional[dict] = None
        self.band = 0.0
        self.tally: dict = {}
        self.record: Optional[List[torch.Tensor]] = None

    def layer(self, i: int) -> Block:
        return self.gpt.h[i] if self.make_layer is None else self.make_layer(i)

    def hidden(self, emb, phase: str):
        """final_norm(ln_f(layers(emb)))."""
        hint = None if self.routes is None else self.routes.get(phase)
        x = emb.float()
        for i in range(self.cfg.num_hidden_layers):
            r = None if hint is None or hint[i] is None else hint[i][:, : x.shape[1]]
            x = self.layer(i)(x, r, self.band, self.tally, self.record)
        return self.final_norm(self.gpt.ln_f(x))

    def _embed_text(self, text):
        g = self.gcfg
        text = F.pad(F.pad(text, (0, 1), value=g.stop_text_token), (1, 0),
                     value=g.start_text_token)
        return self.text_embedding(text) + self.text_pos_embedding.emb.weight[:text.shape[1]]

    def _embed_mel(self, mel):
        return self.mel_embedding(mel) + self.mel_pos_embedding.emb.weight[:mel.shape[1]]

    def decode_logits(self, text, prompt_codes, served):
        """The mel logits (B, n, V) that predicted each of the n served
        codes after [start_mel; prompt_codes] (see reference/gpt.py)."""
        mel = torch.cat([F.pad(prompt_codes, (1, 0), value=self.gcfg.start_mel_token),
                         served[:, :-1]], dim=1)
        h = self.hidden(torch.cat([self._embed_text(text), self._embed_mel(mel)], dim=1),
                        "decode")
        return self.mel_head(h[:, -served.shape[1]:])

    def forward(self, text_inputs, text_lengths, mel_codes, wav_lengths,
                return_latent: bool = True):
        """The mel segment's hidden states minus its two trailing tokens (B,
        T, D), the diffusion's conditioning (return_latent only)."""
        if not return_latent:
            raise NotImplementedError("the MLA-MoE reference serves; it has no losses")
        g = self.gcfg
        mel_lengths = wav_lengths // self.mel_length_compression
        pos = torch.arange(mel_codes.shape[1], device=mel_codes.device)[None, :]
        mel_codes = torch.where(pos >= (mel_lengths + 1)[:, None], g.stop_mel_token, mel_codes)
        mel_codes = F.pad(mel_codes, (0, 1), value=g.stop_mel_token)
        mel_in = F.pad(mel_codes, (1, 0), value=g.start_mel_token)
        text_emb = self._embed_text(text_inputs)
        h = self.hidden(torch.cat([text_emb, self._embed_mel(mel_in)], dim=1), "latent")
        return h[:, text_emb.shape[1]:][:, :-2]
