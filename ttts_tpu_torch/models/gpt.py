"""UnifiedVoice, port of ttts_tpu/models/gpt.py: a pre-LN GPT-2 over
[start_text; text; stop_text] ++ [start_mel; codes; stop_mel] with dual
learned position tables, and its autoregressive serving loop.

State-dict keys are the reference's (ttts/gpt/model.py wrapping HF GPT2Model:
gpt.h.{i}.attn.c_attn with Conv1D weights stored (in, out)). Single-token
decode runs through the fused decode-attention kernel (ops/cuda) over
per-layer caches laid out (B, H, max_len, dk); the prefill and the
return_latent forward run the flash-attention kernel in its causal mode on
(B, T, H, dk) views of the fused qkv. Each takes its kernel only where the
kernel's domain holds (bf16, dk 64 for decode, chosen once per
`inference_speech` by `decode_attention.pick`; D 32 or 64 for attention,
through `attention.attend`), else the kernel's plain version, as the JAX
package gates its decode kernel.

Dtypes: activations follow the matmul weights' dtype (bf16 after
`cast_for_inference` on the card; training keeps f32 weights and computes
in bf16 under autocast, as the JAX package's `_amp_dtype`); LayerNorms and
heads compute in f32.

Training (`forward(..., return_latent=False)`, model.train()): the stop
rewrite, the aligned [start; x] / [x; stop] streams and the text and mel
cross-entropies, each a mean over every position, with embedding, residual
and attention dropout (GPT2Stack / GPT2Block). Training attention is
`F.scaled_dot_product_attention(is_causal=True, dropout_p=...)` in train
mode where attention dropout is on or autograd records the call, where the
JAX package runs its einsum path with dropout (its optional TPU flash route
is a library kernel, not one of the repo's); every other forward goes
through `attention.attend`, whose gate takes the plain version when autograd
records the call.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ttts_tpu_torch.config import GPTConfig
from ttts_tpu_torch.models.sampling import SamplingParams, sample_logits
from ttts_tpu_torch.ops.cuda import _build, attention, decode_attention

Cache = List[Tuple[torch.Tensor, torch.Tensor]]


def gelu_new(x):
    """GPT-2 tanh-approximated GELU."""
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


class Conv1D(nn.Module):
    """HF GPT-2 linear: weight (in, out), y = x @ W + b, in W's dtype."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(d_in, d_out) * 0.02)
        self.bias = nn.Parameter(torch.zeros(d_out))

    def forward(self, x):
        w = self.weight
        return torch.addmm(self.bias.to(w.dtype), x.reshape(-1, x.shape[-1]).to(w.dtype),
                           w).reshape(*x.shape[:-1], w.shape[1])


class LayerNorm(nn.LayerNorm):
    """LayerNorm computed in f32 (its output stays f32, as flax promotes)."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps)


class GPT2Block(nn.Module):
    def __init__(self, dim: int, heads: int, dropout: float = 0.0,
                 attn_dropout: Optional[float] = None):
        super().__init__()
        self.heads = heads
        self.dropout = dropout  # HF resid_pdrop; attn_pdrop defaults to it
        self.attn_dropout = dropout if attn_dropout is None else attn_dropout
        self.ln_1 = LayerNorm(dim, eps=1e-5)
        self.attn = nn.Module()
        self.attn.c_attn = Conv1D(dim, 3 * dim)
        self.attn.c_proj = Conv1D(dim, dim)
        self.ln_2 = LayerNorm(dim, eps=1e-5)
        self.mlp = nn.Module()
        self.mlp.c_fc = Conv1D(dim, 4 * dim)
        self.mlp.c_proj = Conv1D(4 * dim, dim)

    def forward(self, x, cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                pos: int = 0, step=None):
        """x (B, T, D) in the activation dtype. With a cache: T > 1 writes
        rows [pos, pos+T) and attends causally over those fresh rows (the
        prefix is self-contained); T == 1 is one decode step at row `pos`
        through `step`, the decode-attention function (decode_attention.pick's
        choice, made here when not given). Without: causal self-attention
        over x; in train mode (no cache), where attention dropout is on or
        autograd records the call, through SDPA with attention dropout."""
        b, t, d = x.shape
        h = self.heads
        dk = d // h
        q, k, v = self.attn.c_attn(self.ln_1(x)).split(d, dim=-1)
        if cache is not None and t == 1:
            step = step or decode_attention.pick(q.dtype, dk, q)
            a = step(q.reshape(b, h, dk), k.reshape(b, h, dk), v.reshape(b, h, dk), *cache, pos)
            a = a.reshape(b, 1, d).to(x.dtype)
        else:
            q, k, v = (z.reshape(b, t, h, dk) for z in (q, k, v))
            if cache is not None:
                cache[0][:, :, pos: pos + t] = k.transpose(1, 2)
                cache[1][:, :, pos: pos + t] = v.transpose(1, 2)
            train = self.training and (self.attn_dropout > 0 or _build.records_grad(q, k, v))
            if train and cache is None:
                a = F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
                    dropout_p=self.attn_dropout).transpose(1, 2).reshape(b, t, d)
            else:
                a = attention.attend(q, k, v, causal=True).reshape(b, t, d)
        p = self.dropout if self.training else 0.0
        x = x + F.dropout(self.attn.c_proj(a), p)
        return x + F.dropout(self.mlp.c_proj(gelu_new(self.mlp.c_fc(self.ln_2(x)))), p)


class UnifiedVoice(nn.Module):
    def __init__(self, cfg: GPTConfig, mel_length_compression: int = 1024):
        super().__init__()
        c = self.cfg = cfg
        self.mel_length_compression = mel_length_compression
        self.text_embedding = nn.Embedding(c.number_text_tokens + 1, c.model_dim)
        self.mel_embedding = nn.Embedding(c.number_mel_codes, c.model_dim)
        self.text_pos_embedding = nn.Module()
        self.text_pos_embedding.emb = nn.Embedding(c.max_text_tokens + 2, c.model_dim)
        self.mel_pos_embedding = nn.Module()
        self.mel_pos_embedding.emb = nn.Embedding(c.max_mel_tokens + 2, c.model_dim)
        for emb in (self.text_embedding, self.mel_embedding,
                    self.text_pos_embedding.emb, self.mel_pos_embedding.emb):
            nn.init.normal_(emb.weight, std=0.02)
        self.gpt = nn.Module()
        self.gpt.h = nn.ModuleList(GPT2Block(c.model_dim, c.heads, c.dropout, c.attn_dropout)
                                   for _ in range(c.layers))
        self.gpt.ln_f = LayerNorm(c.model_dim, eps=1e-5)
        self.final_norm = LayerNorm(c.model_dim, eps=1e-5)
        self.text_head = nn.Linear(c.model_dim, c.number_text_tokens + 1)
        self.mel_head = nn.Linear(c.model_dim, c.number_mel_codes)

    @property
    def act_dtype(self) -> torch.dtype:
        return self.gpt.h[0].attn.c_attn.weight.dtype

    def _stack(self, emb, cache: Optional[Cache] = None, pos: int = 0, step=None):
        x = F.dropout(emb.to(self.act_dtype), self.cfg.dropout if self.training else 0.0)
        for i, block in enumerate(self.gpt.h):
            x = block(x, None if cache is None else cache[i], pos, step)
        return self.gpt.ln_f(x)

    def _head(self, h):
        return _f32_linear(self.mel_head, self.final_norm(h))

    def _embed_text(self, text_inputs):
        c = self.cfg
        text = F.pad(text_inputs, (0, 1), value=c.stop_text_token)
        text = F.pad(text, (1, 0), value=c.start_text_token)
        t = text.shape[1]
        return self.text_embedding(text) + self.text_pos_embedding.emb.weight[:t][None]

    def _embed_mel(self, mel_in):
        t = mel_in.shape[1]
        return self.mel_embedding(mel_in) + self.mel_pos_embedding.emb.weight[:t][None]

    def forward(self, text_inputs, text_lengths, mel_codes, wav_lengths,
                return_latent: bool = True):
        """return_latent: final_norm hidden states of the mel segment minus
        its two trailing tokens (B, T, D), the diffusion conditioning signal
        (model.py:453-500). Else the training losses (model.py:453-511):
        (loss_text, loss_mel, mel_logits), each loss the mean cross-entropy
        over every position of its stream, stop tokens included."""
        c = self.cfg
        mel_lengths = wav_lengths // self.mel_length_compression
        pos = torch.arange(mel_codes.shape[1], device=mel_codes.device)[None, :]
        mel_codes = torch.where(pos >= (mel_lengths + 1)[:, None], c.stop_mel_token, mel_codes)
        mel_codes = F.pad(mel_codes, (0, 1), value=c.stop_mel_token)
        mel_in = F.pad(mel_codes, (1, 0), value=c.start_mel_token)
        text_emb = self._embed_text(text_inputs)
        h = self._stack(torch.cat([text_emb, self._embed_mel(mel_in)], dim=1))
        h = self.final_norm(h)
        h_text, h_mel = h[:, :text_emb.shape[1]], h[:, text_emb.shape[1]:]
        if return_latent:
            return h_mel[:, :-2]
        text_targets = F.pad(text_inputs, (0, 2), value=c.stop_text_token)
        mel_targets = F.pad(mel_codes, (0, 1), value=c.stop_mel_token)
        mel_logits = _f32_linear(self.mel_head, h_mel)
        return (_ce(_f32_linear(self.text_head, h_text), text_targets),
                _ce(mel_logits, mel_targets), mel_logits)

    def prefill(self, text_inputs, prompt_codes, max_len: int):
        """Run the prompt once and fill per-layer caches (B, H, max_len, dk).
        Returns (cache, last_logits (B, V) f32, prefix_len, mel_pos_offset)."""
        c = self.cfg
        text_emb = self._embed_text(text_inputs)
        mel_in = F.pad(prompt_codes, (1, 0), value=c.start_mel_token)
        emb = torch.cat([text_emb, self._embed_mel(mel_in)], dim=1)
        b, p, d = emb.shape
        h = c.heads
        cache = [tuple(torch.zeros(b, h, max_len, d // h, dtype=self.act_dtype,
                                   device=emb.device) for _ in range(2))
                 for _ in range(c.layers)]
        hid = self._stack(emb, cache, 0)
        return cache, self._head(hid[:, -1]), p, mel_in.shape[1]

    def decode_one(self, token, cache: Cache, position: int, mel_position: int, step=None):
        """One decode step at absolute row `position` (mel position
        `mel_position`); caches update in place; `step` as in GPT2Block.
        Returns logits (B, V) f32."""
        emb = (self.mel_embedding(token[:, None])
               + self.mel_pos_embedding.emb.weight[mel_position][None, None])
        return self._head(self._stack(emb, cache, position, step)[:, 0])


def _f32_linear(head: nn.Linear, h):
    """A head in f32, autocast or not (the JAX heads have no compute dtype)."""
    with torch.autocast(h.device.type, enabled=False):
        return F.linear(h.float(), head.weight.float(), head.bias.float())


def _ce(logits, targets):
    """Mean cross-entropy over every position (ttts_tpu gpt._ce)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets.long()[..., None]).mean()


def inference_speech(model: UnifiedVoice, text_inputs, prompt_codes,
                     max_generate_length: int, sampling: SamplingParams,
                     gumbel: torch.Tensor) -> torch.Tensor:
    """Autoregressive mel-code generation (gpt.py:465-588) as a Python loop.

    text_inputs (B, Lt), prompt_codes (B, Lp); gumbel (max_generate_length,
    B, V) is the noise of each step's draw. Returns codes (B,
    max_generate_length), stop_mel_token after each sequence's stop. The
    loop ends once every sequence has stopped."""
    c = model.cfg
    b = text_inputs.shape[0]
    prefix_len = text_inputs.shape[1] + 2 + prompt_codes.shape[1] + 1
    cache, logits, _, mel_off = model.prefill(
        text_inputs, prompt_codes, prefix_len + max_generate_length)
    dev = text_inputs.device
    counts = torch.zeros(b, c.number_mel_codes, dtype=torch.int32, device=dev)
    counts.scatter_add_(1, prompt_codes, torch.ones_like(prompt_codes, dtype=torch.int32))
    tokens = torch.full((b, max_generate_length), c.stop_mel_token, dtype=torch.long,
                        device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    rows = torch.arange(b, device=dev)
    recorded = [p for p in model.parameters() if p.requires_grad] if torch.is_grad_enabled() else []
    step = decode_attention.pick(model.act_dtype, c.model_dim // c.heads, *recorded)  # once a call
    for i in range(max_generate_length):
        tok = sample_logits(logits, counts, sampling, gumbel[i])
        tok = torch.where(done, c.stop_mel_token, tok)
        done = done | (tok == c.stop_mel_token)
        counts[rows, tok] += 1
        tokens[:, i] = tok
        if bool(done.all()):
            break
        logits = model.decode_one(tok, cache, prefix_len + i, mel_off + i, step)
    return tokens
