"""A public LLM block as UnifiedVoice's trunk: multi-head latent attention
(MLA) and sigmoid-routed experts with shared experts, as the published
`deepseek_v3` modelling computes them (Moonlight-16B-A3B's config.json:
config.MLAMoEConfig). LLM-backbone TTS keeps its own embeddings and heads
around such a stack; UnifiedVoice(cfg, trunk=MLAMoEConfig(...)) builds
these blocks in place of its GPT-2 blocks (models/gpt.py).

For layer l and x (B, T, D):
  h = x + MLA(RMSNorm(x));  y = h + FFN_l(RMSNorm(h))          (eps rms_norm_eps)
  MLA: q = W_q x, 16 heads of (128 nope + 64 rope); [c; k_pe] = W_kva x,
       c <- RMSNorm_kv(c) (512), k_pe (64) shared by the heads;
       [k_nope_h; v_h] = W_kvb c; RoPE (theta rope_theta) on q_pe and k_pe at
       the absolute position, its pairs de-interleaved before rotate-half;
       score = (q_nope_h . k_nope_h + q_pe_h . k_pe) / sqrt(192), causal;
       out = W_o [sum p v_h]_h.
  FFN_0: W_d(silu(W_g x) * W_u x), width intermediate_size;
  FFN_l>=1: s = sigmoid(W_r x) in f32; the top num_experts_per_tok of
       s + e_score_correction_bias chosen; w = routed_scaling_factor *
       s / (sum s + 1e-20); sum_k w_k E_k(x) + S(x), E the routed SwiGLU
       experts (moe_intermediate_size), S the shared ones merged into one
       SwiGLU of n_shared_experts times that width.

The cache of a layer is the block's own: one (B, L, 512 + 64) tensor of c
(after its norm) and k_pe (after RoPE) a position, shared by the heads. A
prefill writes its rows and attends over them in the full form; a decode
step (T = 1) runs the absorbed form over the cache, equal in exact
arithmetic: q~_h = W_UK,h^T q_nope_h, score = (q~_h . c + q_pe_h . k_pe) /
sqrt(192), o_h = W_UV,h sum p c. A decode position is an int or an int32
word on the device (the cache row), so a CUDA graph of the step follows it.

The routed experts run as one grouped call (ops/cuda/moe.moe_experts) on
the (token, expert) pairs sorted by expert on the device, with the group
sizes left there; the combine over a token's experts is a gather-sum. The
router, the norms and the heads stay f32; the rest computes in the weights'
dtype (bf16 on the card). Each layer's attention, routing and experts run
inside `ttts.gpt.mla`, `ttts.gpt.route` and `ttts.gpt.experts` spans.

State-dict keys are the published modelling's: self_attn.{q_proj,
kv_a_proj_with_mqa, kv_a_layernorm, kv_b_proj, o_proj}, mlp.{gate_proj,
up_proj, down_proj} (layer 0), mlp.gate.{weight, e_score_correction_bias},
mlp.experts.{i}.{gate,up,down}_proj, mlp.shared_experts.*,
input_layernorm, post_attention_layernorm. The experts are held stacked
(Experts.gate_up, Experts.down) behind state-dict hooks.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ttts_tpu_torch.config import MLAMoEConfig
from ttts_tpu_torch.ops.cuda import moe
from ttts_tpu_torch.utils.logging import span


class RMSNorm(nn.Module):
    """weight * x / sqrt(mean(x^2) + eps), statistics in f32, output in x's
    dtype (DeepseekV3RMSNorm); kept f32."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x):
        x32 = x.float()
        y = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + self.eps)
        return (self.weight.float() * y).to(x.dtype)


@functools.lru_cache(maxsize=8)
def rope_tables(n: int, dim: int, theta: float, device) -> torch.Tensor:
    """(2, n, dim) f32: cos and sin of positions 0..n-1 (DeepseekV3's
    rotary embedding without scaling: the frequencies repeated twice)."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    freqs = torch.outer(torch.arange(n, dtype=torch.float32, device=device), inv)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.stack([emb.cos(), emb.sin()])


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, T, [H,] dim) rotated as the published modelling's
    apply_rotary_pos_emb: the interleaved pairs de-interleaved, then
    x * cos + rotate_half(x) * sin, in f32, with cos / sin (T, dim). Out in
    x's dtype."""
    d = x.shape[-1]
    xf = x.float().unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    rot = torch.cat([-xf[..., d // 2:], xf[..., : d // 2]], dim=-1)
    shape = (cos.shape[0],) + (1,) * (x.dim() - 3) + (d,)
    return (xf * cos.reshape(shape) + rot * sin.reshape(shape)).to(x.dtype)


class MLA(nn.Module):
    def __init__(self, c: MLAMoEConfig):
        super().__init__()
        self.c = c
        h, d = c.num_attention_heads, c.hidden_size
        self.qk_dim = c.qk_nope_head_dim + c.qk_rope_head_dim
        self.q_proj = nn.Linear(d, h * self.qk_dim, bias=False)
        self.kv_a_proj_with_mqa = nn.Linear(d, c.kv_lora_rank + c.qk_rope_head_dim, bias=False)
        self.kv_a_layernorm = RMSNorm(c.kv_lora_rank, c.rms_norm_eps)
        self.kv_b_proj = nn.Linear(c.kv_lora_rank, h * (c.qk_nope_head_dim + c.v_head_dim),
                                   bias=False)
        self.o_proj = nn.Linear(h * c.v_head_dim, d, bias=False)

    def forward(self, x, rope, cache: Optional[torch.Tensor], pos):
        """x (B, T, D) normed; rope (2, n, 64) tables; cache (B, L, 576) or
        None; pos an int or an int32 word (the cache row of x's first
        position)."""
        c = self.c
        b, t, _ = x.shape
        h, nope, r, lat = c.num_attention_heads, c.qk_nope_head_dim, c.qk_rope_head_dim, \
            c.kv_lora_rank
        q = self.q_proj(x).view(b, t, h, self.qk_dim)
        q_nope, q_pe = q.split([nope, r], dim=-1)
        kva = self.kv_a_proj_with_mqa(x)
        latent, k_pe = kva.split([lat, r], dim=-1)
        latent = self.kv_a_layernorm(latent)
        if isinstance(pos, torch.Tensor):
            rows = pos.long() + torch.arange(t, device=x.device)
            cos, sin = rope.index_select(1, rows).unbind(0)
        else:
            rows = None
            cos, sin = rope[:, pos: pos + t].unbind(0)
        q_pe = apply_rope(q_pe, cos, sin)
        k_pe = apply_rope(k_pe, cos, sin)
        scale = 1.0 / math.sqrt(self.qk_dim)
        if cache is not None:
            fresh = torch.cat([latent, k_pe], dim=-1).to(cache.dtype)
            if rows is None:
                cache[:, pos: pos + t] = fresh
            else:
                cache.index_copy_(1, rows, fresh)
        if cache is not None and t == 1:
            o = self._absorbed(q_nope[:, 0], q_pe[:, 0], cache, pos, scale)
        else:
            kv = self.kv_b_proj(latent).view(b, t, h, nope + c.v_head_dim)
            k_nope, v = kv.split([nope, c.v_head_dim], dim=-1)
            k = torch.cat([k_nope, k_pe[:, :, None].expand(b, t, h, r)], dim=-1)
            qf = torch.cat([q_nope, q_pe], dim=-1)
            s = torch.einsum("bthd,bshd->bhts", qf, k).float() * scale
            keep = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
            p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1).to(v.dtype)
            o = torch.einsum("bhts,bshd->bthd", p, v).reshape(b, t, h * c.v_head_dim)
        return self.o_proj(o)

    def _absorbed(self, q_nope, q_pe, cache, pos, scale):
        """One decode step over the cache rows <= pos in the absorbed form:
        q_nope (B, H, 128), q_pe (B, H, 64) → (B, 1, H * v_head_dim)."""
        c = self.c
        b, h = q_nope.shape[:2]
        lat, length = c.kv_lora_rank, cache.shape[1]
        w = self.kv_b_proj.weight.view(h, c.qk_nope_head_dim + c.v_head_dim, lat)
        w_uk, w_uv = w.split([c.qk_nope_head_dim, c.v_head_dim], dim=1)
        q_lat = torch.bmm(q_nope.transpose(0, 1), w_uk).transpose(0, 1)  # (B, H, 512)
        qc = torch.cat([q_lat, q_pe.to(q_lat.dtype)], dim=-1)
        s = torch.bmm(qc, cache.transpose(1, 2)).float() * scale  # (B, H, L)
        later = torch.arange(length, device=cache.device) > pos
        p = torch.softmax(s.masked_fill(later, float("-inf")), dim=-1).to(cache.dtype)
        o_lat = torch.bmm(p, cache[..., :lat])  # (B, H, 512)
        o = torch.bmm(o_lat.transpose(0, 1), w_uv.transpose(1, 2)).transpose(0, 1)
        return o.reshape(b, 1, h * c.v_head_dim)


class SwiGLU(nn.Module):
    """down(silu(gate x) * up x) (DeepseekV3MLP)."""

    def __init__(self, d: int, f: int):
        super().__init__()
        self.gate_proj = nn.Linear(d, f, bias=False)
        self.up_proj = nn.Linear(d, f, bias=False)
        self.down_proj = nn.Linear(f, d, bias=False)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Router(nn.Module):
    """The published MoEGate for n_group = topk_group = 1: sigmoid scores in
    f32, the top k of scores + e_score_correction_bias chosen, the chosen
    scores normalised and scaled. Kept f32."""

    def __init__(self, c: MLAMoEConfig):
        super().__init__()
        self.k, self.scale, self.norm = (c.num_experts_per_tok, c.routed_scaling_factor,
                                         c.norm_topk_prob)
        self.weight = nn.Parameter(torch.empty(c.n_routed_experts, c.hidden_size))
        self.e_score_correction_bias = nn.Parameter(torch.zeros(c.n_routed_experts))

    def forward(self, x):
        """x (N, D) → (chosen experts (N, k) int64, weights (N, k) f32)."""
        s = torch.sigmoid(F.linear(x.float(), self.weight.float()))
        idx = torch.topk(s + self.e_score_correction_bias.float(), self.k, dim=-1).indices
        w = s.gather(1, idx)
        if self.norm:
            w = w / (w.sum(-1, keepdim=True) + 1e-20)
        return idx, w * self.scale


class Experts(nn.Module):
    """The routed experts stacked: gate_up (E, 2F, D) and down (E, D, F),
    under the published per-expert keys {i}.{gate,up,down}_proj.weight."""

    def __init__(self, e: int, d: int, f: int):
        super().__init__()
        self.f = f
        self.gate_up = nn.Parameter(torch.empty(e, 2 * f, d))
        self.down = nn.Parameter(torch.empty(e, d, f))
        self._register_state_dict_hook(_experts_state)
        self._register_load_state_dict_pre_hook(_experts_load, with_module=True)


def _experts_state(module: Experts, state, prefix, _meta):
    gate_up, down = state.pop(prefix + "gate_up"), state.pop(prefix + "down")
    for i in range(gate_up.shape[0]):
        state[f"{prefix}{i}.gate_proj.weight"] = gate_up[i, : module.f]
        state[f"{prefix}{i}.up_proj.weight"] = gate_up[i, module.f:]
        state[f"{prefix}{i}.down_proj.weight"] = down[i]
    return state


def _experts_load(module: Experts, state, prefix, *_):
    """Copy the per-expert entries into the stacked parameters (no stacked
    copy is made) and hand load_state_dict the parameters themselves; an
    expert missing from `state` leaves its keys to the missing-key check."""
    n = module.gate_up.shape[0]
    names = [(f"{prefix}{i}.{p}_proj.weight", i, p) for i in range(n)
             for p in ("gate", "up", "down")]
    if not all(k in state for k, _, _ in names):
        return
    with torch.no_grad():
        for key, i, p in names:
            v = state.pop(key)
            if p == "down":
                module.down[i].copy_(v)
            else:
                rows = slice(0, module.f) if p == "gate" else slice(module.f, 2 * module.f)
                module.gate_up[i, rows].copy_(v)
    state[prefix + "gate_up"], state[prefix + "down"] = module.gate_up, module.down


class MoE(nn.Module):
    def __init__(self, c: MLAMoEConfig):
        super().__init__()
        self.c = c
        self.gate = Router(c)
        self.experts = Experts(c.n_routed_experts, c.hidden_size, c.moe_intermediate_size)
        self.shared_experts = SwiGLU(c.hidden_size,
                                     c.moe_intermediate_size * c.n_shared_experts)

    def forward(self, x):
        """x (B, T, D) normed."""
        b, t, d = x.shape
        k, n_exp = self.c.num_experts_per_tok, self.c.n_routed_experts
        x2 = x.reshape(b * t, d)
        with span("ttts.gpt.route"):
            idx, w = self.gate(x2)
            dest, counts, token = group_pairs(idx, n_exp)
            ws = w.new_empty(w.numel()).index_copy_(0, dest, w.reshape(-1))
            xs = x2.index_select(0, token)
        with span("ttts.gpt.experts"):
            y = moe.moe_experts(xs, counts, self.experts.gate_up, self.experts.down, ws)
            out = y.index_select(0, dest).view(b * t, k, d).sum(1)
            out = out + self.shared_experts(x2).float()
        return out.to(x.dtype).view(b, t, d)


def group_pairs(idx: torch.Tensor, n_experts: int):
    """The (token, expert) pairs of idx (N, k), pair p = token * k + slot,
    sorted by expert on the device (a stable sort: an expert's pairs keep
    their order), without a host read: (dest (P,) each pair's row in expert
    order, counts (E,) int32, token (P,) the token of each row in expert
    order)."""
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    pairs = torch.arange(flat.numel(), device=idx.device)
    dest = torch.empty_like(order).index_copy_(0, order, pairs)
    counts = torch.zeros(n_experts, dtype=torch.int32, device=idx.device).scatter_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int32))
    return dest, counts, order // idx.shape[1]


class Block(nn.Module):
    """One decoder layer of the trunk; layer < first_k_dense_replace has the
    dense SwiGLU, the others the routed experts."""

    def __init__(self, c: MLAMoEConfig, layer: int):
        super().__init__()
        self.c = c
        self.layer = layer
        self.input_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps)
        self.self_attn = MLA(c)
        self.post_attention_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps)
        self.routed = layer >= c.first_k_dense_replace
        self.mlp = MoE(c) if self.routed else SwiGLU(c.hidden_size, c.intermediate_size)

    @property
    def act_dtype(self) -> torch.dtype:
        return self.self_attn.q_proj.weight.dtype

    def new_cache(self, b: int, max_len: int, device, dtype, tp=None) -> torch.Tensor:
        """The latent cache (B, max_len, 576), zeroed."""
        _no_tp(tp)
        c = self.c
        return torch.zeros(b, max_len, c.kv_lora_rank + c.qk_rope_head_dim, dtype=dtype,
                           device=device)

    def forward(self, x, cache=None, pos=0, step=None, tp=None):
        """x (B, T, D); cache the latent cache of new_cache or None; pos as
        MLA's. `step` (the GPT-2 blocks' decode-attention function) is not
        read; `tp` raises: the trunk has no tensor-parallel path."""
        _no_tp(tp)
        c = self.c
        rope = rope_tables(c.max_position_embeddings, c.qk_rope_head_dim, c.rope_theta,
                           x.device)
        with span("ttts.gpt.mla"):
            x = x + self.self_attn(self.input_layernorm(x), rope, cache, pos)
        return x + self.mlp(self.post_attention_layernorm(x))


def _no_tp(tp) -> None:
    if tp is not None:
        raise NotImplementedError("the MLA-MoE trunk has no tensor-parallel path")


F32_MODULES = (RMSNorm, Router)  # kept in f32 when the trunk is made in a lower dtype


@torch.no_grad()
def materialize(module: nn.Module, device, dtype: torch.dtype, seed: int) -> nn.Module:
    """Make every parameter of `module` that lies on the meta device on
    `device`: those of RMSNorm / Router modules, and those outside
    `Block`s, in f32, the rest in `dtype`, each made at its dtype (no copy
    in another). Values from a generator seeded by `seed`: matrices (and
    stacked experts) N(0, 0.02^2), norm scales 1, biases 0."""
    gen = torch.Generator(device=device).manual_seed(seed)
    inside = set()
    for m in module.modules():
        if isinstance(m, Block):
            inside |= {id(p) for p in m.parameters()}
    for m in module.modules():
        for name, p in list(m.named_parameters(recurse=False)):
            if not p.is_meta:
                continue
            f32 = isinstance(m, F32_MODULES) or id(p) not in inside
            new = torch.empty(p.shape, dtype=torch.float32 if f32 else dtype, device=device)
            if p.dim() >= 2:
                new.normal_(0.0, 0.02, generator=gen)
            elif name in ("bias", "e_score_correction_bias"):
                new.zero_()
            else:
                new.fill_(1.0)
            setattr(m, name, nn.Parameter(new, requires_grad=p.requires_grad))
    for m in module.modules():
        for name, b in list(m.named_buffers(recurse=False)):
            if b.is_meta:
                raise ValueError(f"materialize: buffer {name} of {type(m).__name__} on meta")
    return module
