"""The GPT (UnifiedVoice) in plain f32 PyTorch, under the serving model's
state-dict keys: a pre-LN GPT-2 over [start_text; text; stop_text] ++
[start_mel; codes; stop_mel] with learned text and mel position tables
(ttts/gpt/model.py over HF GPT2Model).

No cache and no kernels: every position is computed by one causal forward
over the whole sequence, which is what a decode through a cache has to
agree with. No dropout: the training reference runs the configuration with
dropout 0.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.config import GPTConfig
from portbench.reference.plain import flash_attention_plain


def gelu_new(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


class Conv1D(nn.Module):
    """HF GPT-2 linear: weight (in, out), y = x @ W + b."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(d_in, d_out))
        self.bias = nn.Parameter(torch.zeros(d_out))

    def forward(self, x):
        return x @ self.weight + self.bias


class LayerNorm(nn.LayerNorm):
    """LayerNorm in f32."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps)


class Block(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.ln_1 = LayerNorm(dim, eps=1e-5)
        self.attn = nn.Module()
        self.attn.c_attn = Conv1D(dim, 3 * dim)
        self.attn.c_proj = Conv1D(dim, dim)
        self.ln_2 = LayerNorm(dim, eps=1e-5)
        self.mlp = nn.Module()
        self.mlp.c_fc = Conv1D(dim, 4 * dim)
        self.mlp.c_proj = Conv1D(4 * dim, dim)

    def forward(self, x):
        b, t, d = x.shape
        q, k, v = (z.reshape(b, t, self.heads, d // self.heads)
                   for z in self.attn.c_attn(self.ln_1(x)).split(d, dim=-1))
        x = x + self.attn.c_proj(flash_attention_plain(q, k, v, causal=True).reshape(b, t, d))
        return x + self.mlp.c_proj(gelu_new(self.mlp.c_fc(self.ln_2(x))))


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
        self.gpt = nn.Module()
        self.gpt.h = nn.ModuleList(Block(c.model_dim, c.heads) for _ in range(c.layers))
        self.gpt.ln_f = LayerNorm(c.model_dim, eps=1e-5)
        self.final_norm = LayerNorm(c.model_dim, eps=1e-5)
        self.text_head = nn.Linear(c.model_dim, c.number_text_tokens + 1)
        self.mel_head = nn.Linear(c.model_dim, c.number_mel_codes)

    def _embed_text(self, text):
        c = self.cfg
        text = F.pad(F.pad(text, (0, 1), value=c.stop_text_token), (1, 0),
                     value=c.start_text_token)
        return self.text_embedding(text) + self.text_pos_embedding.emb.weight[:text.shape[1]]

    def _embed_mel(self, mel):
        return self.mel_embedding(mel) + self.mel_pos_embedding.emb.weight[:mel.shape[1]]

    def hidden(self, emb):
        """final_norm(ln_f(blocks(emb)))."""
        x = emb.float()
        for block in self.gpt.h:
            x = block(x)
        return self.final_norm(self.gpt.ln_f(x))

    def decode_logits(self, text, prompt_codes, served):
        """The mel logits (B, n, V) that predicted each of the `n` served codes
        (B, n) after [start_mel; prompt_codes]: one causal forward over the
        text, the prompt and the served codes but the last."""
        mel = torch.cat([F.pad(prompt_codes, (1, 0), value=self.cfg.start_mel_token),
                         served[:, :-1]], dim=1)
        text_emb = self._embed_text(text)
        h = self.hidden(torch.cat([text_emb, self._embed_mel(mel)], dim=1))
        n = served.shape[1]
        return self.mel_head(h[:, -n:])

    def forward(self, text_inputs, text_lengths, mel_codes, wav_lengths,
                return_latent: bool = True):
        """return_latent: the mel segment's hidden states minus its two
        trailing tokens (B, T, D). Else (text CE, mel CE), each a mean over
        every position of its stream, stop tokens included."""
        c = self.cfg
        mel_lengths = wav_lengths // self.mel_length_compression
        pos = torch.arange(mel_codes.shape[1], device=mel_codes.device)[None, :]
        mel_codes = torch.where(pos >= (mel_lengths + 1)[:, None], c.stop_mel_token, mel_codes)
        mel_codes = F.pad(mel_codes, (0, 1), value=c.stop_mel_token)
        mel_in = F.pad(mel_codes, (1, 0), value=c.start_mel_token)
        text_emb = self._embed_text(text_inputs)
        h = self.hidden(torch.cat([text_emb, self._embed_mel(mel_in)], dim=1))
        h_text, h_mel = h[:, :text_emb.shape[1]], h[:, text_emb.shape[1]:]
        if return_latent:
            return h_mel[:, :-2]
        text_targets = F.pad(text_inputs, (0, 2), value=c.stop_text_token)
        mel_targets = F.pad(mel_codes, (0, 1), value=c.stop_mel_token)
        return _ce(self.text_head(h_text), text_targets), _ce(self.mel_head(h_mel), mel_targets)


def _ce(logits, targets):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets.long()[..., None]).mean()
