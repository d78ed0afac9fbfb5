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
package gates its decode kernel. `GPTConfig.fused_decode=False` takes the
plain decode (decode_attention_plain) outside tensor-parallel serving, as
JAX's decode_attention_reference.

Serving's loop (`inference_speech`) runs one step body over buffers it owns
(_DecodeLoop). On the card, through the decode kernel and without a
tensor-parallel group, the body is captured once per shape as two CUDA
graphs (the draw, the model's step), every position read from int32 words
on the device (the decode kernel's row among them), and replayed every
step; the loop reads whether every row has stopped only every DONE_EVERY
steps, so the host runs ahead of the card. On the CPU, with a
tensor-parallel group, under autograd recording or through the plain
decode, the body runs eagerly, the model's step given its rows as ints,
and the loop reads `done` after every draw.

`UnifiedVoice(cfg, trunk=MLAMoEConfig(...))` builds a public LLM block's
layers (models/mla_moe.py: latent attention, routed and shared experts)
in place of the GPT-2 blocks: the embeddings, tables, final_norm and heads
stay, each block makes and reads its own cache (new_cache), and the step
body and its graphs serve either trunk.

Dtypes: activations follow the matmul weights' dtype (bf16 after
`cast_for_inference` on the card; training keeps f32 weights and computes
in bf16 under autocast, as the JAX package's `_amp_dtype`); LayerNorms and
heads compute in f32.

Training (`forward(..., return_latent=False)`, model.train()): the stop
rewrite, the aligned [start; x] / [x; stop] streams and the text and mel
cross-entropies, each a mean over every position, with embedding, residual
and attention dropout (GPT2Stack / GPT2Block). Attention without a cache,
where autograd records the call, takes one of two routes:
  - `GPTConfig.flash_attention` on and attention dropout inactive (eval
    mode, or attn_dropout == 0): `attention.FlashCausal` over the fused
    qkv, the causal kernel saving its softmax statistics and a backward of
    hand-written kernels (csrc/attention_bwd.cu): JAX's gate at
    ttts_tpu/models/gpt.py:169-172 for its library flash kernel (JAX takes
    its einsum path on the CPU; the port's CPU run takes the kernels' plain
    versions; on the card it needs bf16 compute (train.amp) and a head
    dim of 32 or 64, and raises otherwise);
  - else, in train mode, `F.scaled_dot_product_attention(is_causal=True,
    dropout_p=...)` where JAX runs its einsum path with dropout.
Every other forward goes through `attention.attend`, whose gate takes the
plain version when autograd records the call. `GPTConfig.checkpointing`
recomputes each block in the backward (torch.utils.checkpoint, the
reference's gradient checkpointing, JAX's nn.remat), with the first pass's
dropout masks.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from ttts_tpu_torch.config import GPTConfig, MLAMoEConfig
from ttts_tpu_torch.models import mla_moe
from ttts_tpu_torch.models.sampling import SamplingParams, sample_logits
from ttts_tpu_torch.ops.cuda import _build, attention, decode_attention, moe
from ttts_tpu_torch.parallel.mesh import all_gather
from ttts_tpu_torch.utils.logging import span

Cache = list  # a layer's own cache: GPT2Block's (k, v), mla_moe.Block's latent tensor


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
                 attn_dropout: Optional[float] = None, flash: bool = False,
                 fused_decode: bool = True):
        super().__init__()
        self.heads = heads
        self.dropout = dropout  # HF resid_pdrop; attn_pdrop defaults to it
        self.attn_dropout = dropout if attn_dropout is None else attn_dropout
        self.flash = flash  # GPTConfig.flash_attention: FlashCausal when it applies
        self.fused_decode = fused_decode
        self.ln_1 = LayerNorm(dim, eps=1e-5)
        self.attn = nn.Module()
        self.attn.c_attn = Conv1D(dim, 3 * dim)
        self.attn.c_proj = Conv1D(dim, dim)
        self.ln_2 = LayerNorm(dim, eps=1e-5)
        self.mlp = nn.Module()
        self.mlp.c_fc = Conv1D(dim, 4 * dim)
        self.mlp.c_proj = Conv1D(4 * dim, dim)

    @property
    def act_dtype(self) -> torch.dtype:
        return self.attn.c_attn.weight.dtype

    def new_cache(self, b: int, max_len: int, device, dtype, tp=None):
        """Zeroed (k, v) caches (B, H, max_len, dk), or, for a
        tensor-parallel group `tp`, of this rank's H/tp heads only."""
        h = self.heads // (1 if tp is None else dist.get_world_size(tp))
        dk = self.attn.c_proj.weight.shape[0] // self.heads
        return tuple(torch.zeros(b, h, max_len, dk, dtype=dtype, device=device)
                     for _ in range(2))

    def forward(self, x, cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                pos=0, step=None, tp=None):
        """x (B, T, D) in the activation dtype. With a cache: T > 1 writes
        rows [pos, pos+T) and attends causally over those fresh rows (the
        prefix is self-contained); T == 1 is one decode step at row `pos` (an
        int, or an int32 word on the device: decode_attention's `pos`)
        through `step`, the decode-attention function (decode_attention.pick's
        choice, or the plain decode without fused_decode, made here when not
        given). Without: causal self-attention over x; where autograd records
        the call, through FlashCausal with `flash` when attention dropout is
        inactive, else in train mode through SDPA with attention dropout.

        `tp` (a process group of tensor-parallel shards, serving only): this
        rank computes q/k/v and attention for its contiguous heads
        (decode_attention.head_chunk; the cache holds only them) and the
        heads' outputs are all-gathered before c_proj; the rest of the
        block runs replicated."""
        b, t, d = x.shape
        h = self.heads
        dk = d // h
        if tp is None:
            qkv = self.attn.c_attn(self.ln_1(x))
        else:
            h = h // dist.get_world_size(tp)
            w, bias = self._local_qkv(tp)
            xn = self.ln_1(x)
            qkv = torch.addmm(bias.to(w.dtype), xn.reshape(-1, d).to(w.dtype),
                              w).reshape(b, t, 3 * h * dk)
        q, k, v = qkv.split(h * dk, dim=-1)
        flash = (self.flash and cache is None and tp is None and _build.records_grad(qkv)
                 and not (self.training and self.attn_dropout > 0))
        if flash:
            a = attention.FlashCausal.apply(qkv, h)
        elif cache is not None and t == 1:
            step = step or (decode_attention.pick(q.dtype, dk, q) if self.fused_decode
                            else decode_attention.decode_attention_plain)
            a = decode_attention.decode_attention_spmd(
                q.reshape(b, h, dk), k.reshape(b, h, dk), v.reshape(b, h, dk), *cache, pos,
                tp, step)
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
                a = attention.attend(q, k, v, causal=True)
                if tp is not None:
                    a = all_gather(a, tp, 2)
                a = a.reshape(b, t, d)
        p = self.dropout if self.training else 0.0
        x = x + F.dropout(self.attn.c_proj(a), p)
        return x + F.dropout(self.mlp.c_proj(gelu_new(self.mlp.c_fc(self.ln_2(x)))), p)

    def _local_qkv(self, tp):
        """c_attn's columns and bias of this rank's heads: [q; k; v] of the
        head chunk, relaid once per weight version."""
        w, bias = self.attn.c_attn.weight, self.attn.c_attn.bias
        n, rank = dist.get_world_size(tp), dist.get_rank(tp)
        key = (w.data_ptr(), w._version, bias._version, rank, n)
        if key != getattr(self, "_qkv_key", None):
            d, dk = w.shape[0], w.shape[0] // self.heads
            hs = decode_attention.head_chunk(self.heads, rank, n)
            cols = torch.cat([torch.arange(j * d + hs.start * dk, j * d + hs.stop * dk)
                              for j in range(3)]).to(w.device)
            self._qkv, self._qkv_key = (w[:, cols].contiguous(), bias[cols]), key
        return self._qkv


class UnifiedVoice(nn.Module):
    def __init__(self, cfg: GPTConfig, mel_length_compression: int = 1024,
                 trunk: Optional[MLAMoEConfig] = None):
        """`trunk`: None builds the GPT-2 blocks; an MLAMoEConfig builds its
        blocks (models/mla_moe.py, whose settings must match `cfg`:
        MLAMoEConfig.check_matches) with an RMSNorm ln_f. The embeddings,
        position tables, final_norm and heads are the same either way."""
        super().__init__()
        c = self.cfg = cfg
        self.trunk = trunk
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
        if trunk is None:
            self.gpt.h = nn.ModuleList(GPT2Block(c.model_dim, c.heads, c.dropout,
                                                 c.attn_dropout, c.flash_attention,
                                                 c.fused_decode)
                                       for _ in range(c.layers))
            self.gpt.ln_f = LayerNorm(c.model_dim, eps=1e-5)
        else:
            trunk.check_matches(c)
            self.gpt.h = nn.ModuleList(mla_moe.Block(trunk, i) for i in range(c.layers))
            self.gpt.ln_f = mla_moe.RMSNorm(c.model_dim, trunk.rms_norm_eps)
        self.final_norm = LayerNorm(c.model_dim, eps=1e-5)
        self.text_head = nn.Linear(c.model_dim, c.number_text_tokens + 1)
        self.mel_head = nn.Linear(c.model_dim, c.number_mel_codes)
        self.decode_graph = None  # inference_speech's last captured decode: (key, _DecodeGraphs)

    @property
    def act_dtype(self) -> torch.dtype:
        return self.gpt.h[0].act_dtype

    def _stack(self, emb, cache: Optional[Cache] = None, pos=0, step=None, tp=None):
        x = F.dropout(emb.to(self.act_dtype), self.cfg.dropout if self.training else 0.0)
        remat = self.cfg.checkpointing and cache is None and torch.is_grad_enabled()
        for i, block in enumerate(self.gpt.h):
            if remat:  # the saved RNG states replay the first pass's dropout masks
                x = torch.utils.checkpoint.checkpoint(block, x, None, pos, step, tp,
                                                      use_reentrant=False)
            else:
                x = block(x, None if cache is None else cache[i], pos, step, tp)
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

    def new_cache(self, b: int, max_len: int, device, tp=None) -> Cache:
        """Zeroed per-layer caches of max_len rows, each the block's own
        (GPT2Block: (k, v) (B, H, max_len, dk), for a tensor-parallel group
        `tp` of this rank's H/tp heads only; mla_moe.Block: the latent cache
        (B, max_len, 576))."""
        return [block.new_cache(b, max_len, device, self.act_dtype, tp)
                for block in self.gpt.h]

    def prefill(self, text_inputs, prompt_codes, max_len: int, tp=None,
                cache: Optional[Cache] = None):
        """Run the prompt once and fill its rows of per-layer caches: `cache`
        (a decode loop's own, max_len rows) or new ones (new_cache). Returns
        (cache, last_logits (B, V) f32, prefix_len, mel_pos_offset)."""
        c = self.cfg
        text_emb = self._embed_text(text_inputs)
        mel_in = F.pad(prompt_codes, (1, 0), value=c.start_mel_token)
        emb = torch.cat([text_emb, self._embed_mel(mel_in)], dim=1)
        if cache is None:
            cache = self.new_cache(emb.shape[0], max_len, emb.device, tp)
        hid = self._stack(emb, cache, 0, tp=tp)
        return cache, self._head(hid[:, -1]), emb.shape[1], mel_in.shape[1]

    def decode_one(self, token, cache: Cache, position, mel_position, step=None, tp=None):
        """One decode step at absolute row `position` (mel position
        `mel_position`), each an int or a one-element int32 word on the
        token's device (read when the step runs, so a CUDA graph of the step
        follows the word); caches update in place; `step` and `tp` as in
        GPT2Block. Returns logits (B, V) f32."""
        pe = self.mel_pos_embedding.emb.weight[mel_position]  # (D,), or (1, D) for a word
        emb = self.mel_embedding(token[:, None]) + pe.reshape(1, 1, -1)
        return self._head(self._stack(emb, cache, position, step, tp)[:, 0])


def _f32_linear(head: nn.Linear, h):
    """A head in f32, autocast or not (the JAX heads have no compute dtype)."""
    with torch.autocast(h.device.type, enabled=False):
        return F.linear(h.float(), head.weight.float(), head.bias.float())


def _ce(logits, targets):
    """Mean cross-entropy over every position (ttts_tpu gpt._ce)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets.long()[..., None]).mean()


CACHE_ROWS = 64  # cache lengths round up to this: nearby prompt lengths share a graph
DONE_EVERY = 8  # decode steps replayed between two reads of the stop word


class _DecodeLoop:
    """What one decode loop owns, and its step. Buffers: the per-layer
    caches, the logits to draw from (B, V) f32, token counts, the drawn
    tokens (B, steps), `done`, the call's Gumbel noise (steps, B, V), the
    token just drawn, and `words`, int32 [step, cache row, mel position] on
    the device, from which a captured step takes every position (the
    noise's row, the tokens' column, the cache row, the position
    embedding). `sample` and `decode` are a step's two halves; each runs
    eagerly or is captured once as a CUDA graph and replayed, and writes
    only these buffers.
    `stop` receives done.all() after every draw, in pinned host memory on
    the card."""

    def __init__(self, model: "UnifiedVoice", rows: int, cache_len: int, steps: int, dev,
                 tp=None):
        v = model.cfg.number_mel_codes
        self.cache = model.new_cache(rows, cache_len, dev, tp)
        self.cache_len = cache_len
        self.logits = torch.zeros(rows, v, device=dev)
        self.counts = torch.zeros(rows, v, dtype=torch.int32, device=dev)
        self.tokens = torch.zeros(rows, steps, dtype=torch.long, device=dev)
        self.tok = torch.zeros(rows, dtype=torch.long, device=dev)
        self.done = torch.zeros(rows, dtype=torch.bool, device=dev)
        self.noise = torch.zeros(steps, rows, v, device=dev)
        self.words = torch.zeros(3, dtype=torch.int32, device=dev)
        self.rows = torch.arange(rows, device=dev)
        card = dev.type == "cuda"
        self.stop = torch.zeros((), dtype=torch.bool, pin_memory=card)
        self.event = torch.cuda.Event() if card else None

    def start(self, model: "UnifiedVoice", text_inputs, prompt_codes, gumbel, tp=None):
        """Set the buffers for a call: the words at step 0, the prompt's
        cache rows and last logits, the prompt's code counts, no token
        drawn, the call's noise. Raises where the last step's cache row
        would lie outside the caches (the decode kernel reads the row from
        the device and is given no other check)."""
        c = model.cfg
        steps, cache_len = self.tokens.shape[1], self.cache_len
        prefix_len = text_inputs.shape[1] + 2 + prompt_codes.shape[1] + 1
        if prefix_len + steps > cache_len:
            raise ValueError(f"decode: {prefix_len} prompt rows and {steps} steps overrun "
                             f"caches of {cache_len} rows")
        self.prefix_len, self.mel_off = prefix_len, prompt_codes.shape[1] + 1
        self.words.copy_(torch.tensor([0, prefix_len, self.mel_off], dtype=torch.int32))
        _, logits, _, _ = model.prefill(text_inputs, prompt_codes, cache_len, tp, self.cache)
        self.logits.copy_(logits)
        self.counts.zero_().scatter_add_(1, prompt_codes,
                                         torch.ones_like(prompt_codes, dtype=torch.int32))
        self.tokens.fill_(c.stop_mel_token)
        self.done.zero_()
        self.noise.copy_(gumbel)

    def sample(self, sampling: SamplingParams, stop_token: int):
        """Draw the step's tokens; a row that has stopped draws the stop
        token again."""
        i = self.words[:1]
        tok = sample_logits(self.logits, self.counts, sampling, self.noise.index_select(0, i)[0])
        tok = torch.where(self.done, stop_token, tok)
        self.done |= tok == stop_token
        self.counts[self.rows, tok] += 1
        self.tokens.scatter_(1, i.long().expand(tok.shape[0], 1), tok[:, None])
        self.tok.copy_(tok)
        self.stop.copy_(self.done.all(), non_blocking=True)

    def decode(self, model: "UnifiedVoice", step, tp=None, i: Optional[int] = None):
        """The model's step on the drawn tokens, then the next step's words.
        The cache row and mel position come from the words, or, given the
        host's step `i` (the eager loop), as ints: the plain decode slices
        its rows on the host, and would read a word with a synchronise."""
        if i is None:
            at = self.words[1:2], self.words[2:3]
        else:
            at = self.prefix_len + i, self.mel_off + i
        self.logits.copy_(model.decode_one(self.tok, self.cache, *at, step, tp))
        self.words += 1

    def all_done(self) -> bool:
        """Whether every row had stopped at the last draw (a synchronise on
        the card)."""
        if self.event is not None:
            self.event.record()
            self.event.synchronize()
        return bool(self.stop)


# the kernel wrappers whose launch counts a replayed decode step adds to
GRAPH_COUNTED = (decode_attention.decode_attention, moe.moe_experts)


class _DecodeGraphs:
    """A decode loop with its step captured as two CUDA graphs, the draw
    (`sample`) and the model's step (`decode`), sharing one memory pool
    that holds the step's scratch. Warmed up once on a side stream, as
    torch.cuda.graphs asks, then captured. `launches`: the launches each
    wrapper of GRAPH_COUNTED counted while the model's step was captured,
    which each replay makes (replay_decode adds them to its count)."""

    def __init__(self, model: "UnifiedVoice", loop: _DecodeLoop, sampling: SamplingParams,
                 step):
        self.loop = loop
        stop = model.cfg.stop_mel_token
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            loop.sample(sampling, stop)
            loop.decode(model, step)
        torch.cuda.current_stream().wait_stream(side)
        self.sample, self.decode = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.sample):
            loop.sample(sampling, stop)
        launched = [fn.launches for fn in GRAPH_COUNTED]
        with torch.cuda.graph(self.decode, pool=self.sample.pool()):
            loop.decode(model, step)
        self.launches = [fn.launches - n for fn, n in zip(GRAPH_COUNTED, launched)]
        for fn, n in zip(GRAPH_COUNTED, launched):
            fn.launches = n  # a capture launches nothing

    def replay_decode(self):
        self.decode.replay()
        for fn, n in zip(GRAPH_COUNTED, self.launches):
            fn.launches += n


def _decode_graphs(model: "UnifiedVoice", rows: int, cache_len: int, steps: int,
                   sampling: SamplingParams, dev, step) -> _DecodeGraphs:
    """The model's captured decode for this shape, sampler and weights
    (their storage and version, so an in-place update captures anew, as
    GPT2Block._local_qkv relays its weights). The model keeps one, the last
    used (each serving cell calls one shape): another key releases it, then
    captures its own. What it holds stays on the card between calls
    (`model.decode_graph = None` releases it): the caches, the noise and
    the pool with the sampler's (rows, V, V) scratch."""
    weights = tuple((p.data_ptr(), p._version) for p in model.parameters())
    key = (rows, cache_len, steps, model.cfg.number_mel_codes, sampling, dev, model.training,
           weights)
    if model.decode_graph is None or model.decode_graph[0] != key:
        model.decode_graph = None
        loop = _DecodeLoop(model, rows, cache_len, steps, dev)
        with torch.no_grad():
            model.decode_graph = key, _DecodeGraphs(model, loop, sampling, step)
        inference_speech.graphs["captures"] += 1
    return model.decode_graph[1]


def inference_speech(model: UnifiedVoice, text_inputs, prompt_codes,
                     max_generate_length: int, sampling: SamplingParams,
                     gumbel: torch.Tensor, tp=None) -> torch.Tensor:
    """Autoregressive mel-code generation (gpt.py:465-588).

    text_inputs (B, Lt), prompt_codes (B, Lp); gumbel (max_generate_length,
    B, V) is the noise of each step's draw. Returns codes (B,
    max_generate_length), stop_mel_token after each sequence's stop.

    The step is one body (_DecodeLoop: the draw, then the model's step,
    every position read from words on the device). On the card, through the
    decode kernel and without a tensor-parallel group, it runs as two CUDA
    graphs captured once per shape (_decode_graphs: rows, cache length
    rounded up to CACHE_ROWS, max_generate_length, V, the sampler, the
    weights; the model keeps the last) and replayed every step; the loop reads whether every row has
    stopped after every DONE_EVERY-th draw, as the JAX loop tests `done` on
    the device (rows that have stopped draw the stop token, so the steps
    after the last stop change no code), so the host runs ahead of the
    card. The step runs eagerly, testing `done` after every draw and giving
    the model's step its positions as ints, where the input rules a graph
    out: a CPU device, a tensor-parallel group `tp`,
    autograd recording a call on the parameters, or the plain decode
    (GPTConfig.fused_decode off, or decode_attention.kernel_fits false; the
    MLA-MoE trunk's step takes no decode-attention function).
    `inference_speech.graphs` counts captures, and the steps whose draw was
    replayed or ran eagerly.

    `tp`: a process group of tensor-parallel shards over the heads (JAX's
    tp_shards / decode_spmd, gpt.py:474): the parameters stay replicated,
    each rank holds and attends over its own heads' caches through the
    decode kernel, and every rank draws the same tokens from the same
    `gumbel`. Each step is a `ttts.gpt.decode_step` span, its draw through
    the writes of the drawn tokens a `ttts.gpt.sample` span inside it
    (utils.logging.span); replays sit in the same spans."""
    c = model.cfg
    b, dev = text_inputs.shape[0], text_inputs.device
    prefix_len = text_inputs.shape[1] + 2 + prompt_codes.shape[1] + 1
    cache_len = -(-(prefix_len + max_generate_length) // CACHE_ROWS) * CACHE_ROWS
    recorded = [p for p in model.parameters() if p.requires_grad] if torch.is_grad_enabled() else []
    if model.trunk is not None:  # every kernel of its step reads positions from the device
        step = None
        kernels = not recorded
    elif c.fused_decode or tp is not None:  # once a call
        step = decode_attention.pick(model.act_dtype, c.model_dim // c.heads, *recorded)
        kernels = step is decode_attention.decode_attention
    else:  # JAX's decode_attention_reference (its decode_spmd, here tp, ignores the flag)
        step = decode_attention.decode_attention_plain
        kernels = False
    graphs = None
    if dev.type == "cuda" and tp is None and kernels:
        graphs = _decode_graphs(model, b, cache_len, max_generate_length, sampling, dev, step)
        loop = graphs.loop
    else:
        loop = _DecodeLoop(model, b, cache_len, max_generate_length, dev, tp)
    loop.start(model, text_inputs, prompt_codes, gumbel, tp)
    count = inference_speech.graphs
    for i in range(max_generate_length):
        with span("ttts.gpt.decode_step"):
            with span("ttts.gpt.sample"):
                if graphs is None:
                    loop.sample(sampling, c.stop_mel_token)
                else:
                    graphs.sample.replay()
            count["eager_steps" if graphs is None else "replayed_steps"] += 1
            if (graphs is None or (i + 1) % DONE_EVERY == 0) and loop.all_done():
                break
            if graphs is None:
                loop.decode(model, step, tp, i)
            else:
                graphs.replay_decode()
    return loop.tokens.clone()


inference_speech.graphs = {"captures": 0, "replayed_steps": 0, "eager_steps": 0}
