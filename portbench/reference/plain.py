"""The plain versions behind the copied modules' dispatch: attention,
the scale-shift resblock and the VQ search.

Each function is the arithmetic of its kernel's plain version, in the
inputs' dtype (f32 here), and records autograd like any torch code.
"""

from __future__ import annotations

import math
import types

import torch
import torch.nn.functional as F


# ------------------------------------------------------------------ attention


def toeplitz_bias(strip: torch.Tensor, t: int) -> torch.Tensor:
    """(H, 2T-1) strip → (H, T, T) bias: row i is strip[:, T-1-i : 2T-1-i]."""
    return strip.unfold(1, t, 1).flip(1)


def flash_attention_plain(q, k, v, strip=None, causal: bool = False):
    """q, k, v (B, T, H, D), strip (H, 2T-1) or None → softmax(q k^T /
    sqrt(D) + bias) v (B, T, H, D), keys j > i masked when causal."""
    t, d = q.shape[1], q.shape[3]
    s = torch.einsum("bthd,bshd->bhts", q.float() * (1.0 / math.sqrt(d)), k.float())
    if strip is not None:
        s = s + toeplitz_bias(strip.float(), t)[None]
    if causal:
        keep = torch.ones(t, s.shape[-1], dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, torch.finfo(s.dtype).min)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bshd->bthd", p, v.float()).to(q.dtype)


attention = types.SimpleNamespace(
    attend=lambda q, k, v, strip=None, causal=False: flash_attention_plain(q, k, v, strip,
                                                                            causal),
    flash_attention_plain=flash_attention_plain, toeplitz_bias=toeplitz_bias)


# ------------------------------------------------------------------- resblock


def _gn(h: torch.Tensor, groups: int, eps: float) -> torch.Tensor:
    b, t, c = h.shape
    g = h.reshape(b, t, groups, c // groups)
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = g.var(dim=(1, 3), keepdim=True, unbiased=False)
    return ((g - mean) * torch.rsqrt(var + eps)).reshape(b, t, c)


def scale_shift_resblock(x, g1, b1, w1, bd1, a2, b2, w3, bc3, groups: int = 32,
                         eps: float = 1e-5):
    """x (B, T, C); GN_1 affine g1, b1; w1 (C, C) as (in, out) and bias bd1;
    the combined GN_2 x FiLM affine a2, b2 (B, C); w3 (3, C, C) as (tap, in,
    out) and bias bc3 → x + conv3(silu(GN_2 affine(w1 silu(GN_1 x))))."""
    dt = x.dtype
    xf = x.float()
    h = F.silu(_gn(xf, groups, eps) * g1.float() + b1.float())
    h = h @ w1.float() + bd1.float()
    h = F.silu(_gn(h, groups, eps) * a2.float()[:, None] + b2.float()[:, None])
    w3 = w3.float()
    pad = torch.zeros_like(h[:, :1])
    y = h @ w3[1]
    y = y + torch.cat([pad, h[:, :-1]], dim=1) @ w3[0]
    y = y + torch.cat([h[:, 1:], pad], dim=1) @ w3[2]
    return (xf + y + bc3.float()).to(dt)


resblock = types.SimpleNamespace(scale_shift_resblock=scale_shift_resblock)


# ------------------------------------------------------------------------ VQ


def nearest(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """argmin_j ||x_i - e_j||^2 in f32 → (N,) int32, ties to the lowest index."""
    x, codebook = x.float(), codebook.float()
    dist = ((x * x).sum(1, keepdim=True) - 2.0 * (x @ codebook.T)
            + (codebook * codebook).sum(1)[None])
    return torch.argmin(dist, dim=-1).to(torch.int32)


vq = types.SimpleNamespace(nearest=nearest)


# ------------------------------------------------------- one process, no mesh
