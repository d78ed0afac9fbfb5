"""Flash attention over (B, T, H, D), with an optional additive Toeplitz
(relative-position) bias and an optional causal mask.

Kernel: ttts_tpu_torch/csrc/attention.cu, replacing ttts_tpu/ops/pallas/
attention.py (flash_attention) in all four of its modes with one Hopper
kernel: wgmma for Q.K^T and P.V, Q/K/V tiles by TMA (each view of q, k, v
becomes a tensor map, built from the strides `_strides` checks). The bias is
given as its (H, 2T-1) diagonal strip: bias[h, i, j] = strip[h, j-i+T-1];
each block stages the strip segment its queries meet in shared memory once.
The launch counts are kept per mode ("bias", "nobias", "causal",
"bias_causal"), so that a run shows which modes it took.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ttts_tpu_torch.ops.cuda import _build

# (has a bias strip, causal) → the mode's name in `flash_attention.launches`
MODES = {(True, False): "bias", (False, False): "nobias", (False, True): "causal",
         (True, True): "bias_causal"}


def toeplitz_bias(strip: torch.Tensor, t: int) -> torch.Tensor:
    """(H, 2T-1) strip → (H, T, T) bias: row i is strip[:, T-1-i : 2T-1-i],
    a window of the strip (unfold, whose backward sums in a fixed order, so
    that a training step through the plain version repeats bit for bit)."""
    return strip.unfold(1, t, 1).flip(1)


def flash_attention_plain(q, k, v, strip=None, causal: bool = False):
    """q, k, v: (B, T, H, D); strip: (H, 2T-1) or None. f32 scores and
    softmax, the scale 1/sqrt(D) folded into q in q's dtype, keys j > i
    filled with the f32 minimum when causal, as the TPU kernel does →
    (B, T, H, D). Under autocast the two products take autocast's dtype
    (the scores' minimum then is that dtype's), as the JAX package's bf16
    training einsums do."""
    t, d = q.shape[1], q.shape[3]
    qs = (q.float() * (1.0 / math.sqrt(d))).to(q.dtype).float()
    s = torch.einsum("bthd,bshd->bhts", qs, k.float())
    if strip is not None:
        s = s + toeplitz_bias(strip.float(), t)[None]
    if causal:
        keep = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, torch.finfo(s.dtype).min)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bshd->bthd", p, v.float()).to(q.dtype)


def _strides(x: torch.Tensor, name: str):
    """(token stride, head stride) of a (B, T, H, D) view whose D is
    contiguous and whose batch stride is T times its token stride."""
    b, t, h, d = x.shape
    st, sh = x.stride(1), x.stride(2)
    if (x.stride(3) != 1 or (b > 1 and x.stride(0) != t * st) or st % 8 or sh % 8
            or x.data_ptr() % 16):
        raise ValueError(f"flash_attention: {name} must be (B, T, H, D) rows of contiguous "
                         f"D with 16-byte aligned token and head strides, got strides "
                         f"{x.stride()}")
    return st, sh


def _unsupported(q, k, v) -> Optional[str]:
    """Why the kernel's domain does not hold for these dtypes and shapes, or
    None."""
    if any(x.dtype != torch.bfloat16 for x in (q, k, v)):
        return "the kernel takes bfloat16 q, k, v"
    if k.shape != q.shape or v.shape != q.shape or q.ndim != 4 or q.shape[3] not in (32, 64):
        return f"unsupported shapes {tuple(q.shape)} (D 32 or 64)"
    return None


def kernel_fits(q, k, v) -> bool:
    """Whether the kernel's domain (bf16 q, k, v of one (B, T, H, D) shape,
    D 32 or 64) holds: the gate `attend` takes before any launch, as
    ttts_tpu's call sites gate theirs. The views' strides and the strip's
    shape are not part of it: the wrapper raises on those."""
    return _unsupported(q, k, v) is None


def attend(q, k, v, strip=None, causal: bool = False) -> torch.Tensor:
    """The model call sites' attention: the kernel where its domain holds
    (kernel_fits) and autograd would not record the call
    (_build.records_grad), else flash_attention_plain."""
    use = kernel_fits(q, k, v) and not _build.records_grad(q, k, v, strip)
    fn = flash_attention if use else flash_attention_plain
    return fn(q, k, v, strip, causal)


def flash_attention(q, k, v, strip=None, causal: bool = False) -> torch.Tensor:
    """See flash_attention_plain. On CUDA the inputs are in the kernel's
    domain (kernel_fits): bf16 q, k, v with D in {32, 64}, each possibly a
    strided view of a fused qkv tensor that `_strides` accepts, and none
    requires grad under grad mode (the kernel has no backward)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, strip, causal)
    _build.refuse_grad("flash_attention", q, k, v, strip)
    tensors = (k, v) if strip is None else (k, v, strip)
    if q.device.type != "cuda" or any(x.device != q.device for x in tensors):
        raise ValueError("flash_attention: all tensors must be on one CUDA device")
    why = _unsupported(q, k, v)
    if why:
        raise ValueError(f"flash_attention: {why}")
    b, t, h, d = q.shape
    strip_ptr, strip_stride = None, 0
    if strip is not None:
        if strip.shape != (h, 2 * t - 1):
            raise ValueError(f"flash_attention: strip {tuple(strip.shape)} != {(h, 2 * t - 1)}")
        strip = strip.float().contiguous()
        strip_ptr, strip_stride = strip.data_ptr(), strip.stride(0)
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    _build.launch("ttts_flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  strip_ptr, out.data_ptr(), b, t, h, d, *_strides(q, "q"),
                  *_strides(k, "k"), *_strides(v, "v"), strip_stride, int(causal),
                  1.0 / math.sqrt(d))
    flash_attention.launches[MODES[strip is not None, bool(causal)]] += 1
    return out


flash_attention.launches = dict.fromkeys(MODES.values(), 0)
