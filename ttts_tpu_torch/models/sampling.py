"""Logits warpers and the token draw, port of ttts_tpu/models/sampling.py
(the JAX package's order: repetition penalty → temperature → typical →
top-k → top-p).

The draw is argmax(logits + gumbel): jax.random.categorical(key, l) is
exactly argmax(l + jax.random.gumbel(key, l.shape)), so Gumbel noise taken
from JAX reproduces its draws, and noise from a torch.Generator gives the
same distribution.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class SamplingParams(NamedTuple):
    temperature: float = 0.8
    top_p: float = 0.8
    top_k: int = 0  # 0 = disabled
    repetition_penalty: float = 2.0
    typical_sampling: bool = False
    typical_mass: float = 0.9


def apply_repetition_penalty(logits, counts, penalty: float):
    """Seen tokens (counts > 0): logit > 0 → /penalty, else *penalty."""
    if penalty == 1.0:
        return logits
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(counts > 0, penalized, logits)


def apply_top_k(logits, top_k: int):
    if top_k <= 0:
        return logits
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


def apply_top_p(logits, top_p: float):
    """Nucleus filtering, min_tokens_to_keep=1: token i is kept iff the
    probability mass of strictly greater logits is < top_p (equal-valued
    boundary tokens share one mass, as in the sort formulation). Sort-free,
    as the JAX package does for decode-sized vocabularies: O(V^2) per row,
    1 M compares at the GPT's V = 1026."""
    if top_p >= 1.0:
        return logits
    p = torch.softmax(logits, dim=-1)
    gt = logits[..., None, :] > logits[..., :, None]  # (..., V_i, V_j)
    mass = torch.where(gt, p[..., None, :], 0.0).sum(-1)
    return logits.masked_fill(mass >= top_p, float("-inf"))


def apply_typical(logits, mass: float):
    """Typical decoding, as ttts_tpu's apply_typical: rank the tokens by how
    close their surprisal is to the entropy and keep them while their
    cumulative mass, each token's own included, stays below `mass` (the
    most typical token always). The sort is stable, as jnp.argsort: tied
    tokens keep their vocabulary order."""
    logp = torch.log_softmax(logits, dim=-1)
    p = logp.exp()
    ent = -torch.where(p > 0, p * logp, 0.0).sum(-1, keepdim=True)
    order = torch.argsort((-logp - ent).abs(), dim=-1, stable=True)
    keep_sorted = p.gather(-1, order).cumsum(-1) < mass
    keep_sorted[..., 0] = True
    keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
    return logits.masked_fill(~keep, float("-inf"))


def warp_logits(logits, counts, params: SamplingParams):
    logits = apply_repetition_penalty(logits, counts, params.repetition_penalty)
    if params.temperature != 1.0:
        logits = logits / params.temperature
    if params.typical_sampling:
        logits = apply_typical(logits, params.typical_mass)
    logits = apply_top_k(logits, params.top_k)
    return apply_top_p(logits, params.top_p)


def sample_gumbel(shape, generator: Optional[torch.Generator] = None,
                  device=None) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(U)), U uniform on [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def sample_logits(logits, counts, params: SamplingParams, gumbel: torch.Tensor):
    """Warp logits (B, V) and draw tokens (B,) as argmax(logits + gumbel)."""
    return torch.argmax(warp_logits(logits, counts, params) + gumbel, dim=-1)
