"""Non-causal attention with an additive Toeplitz (relative-position) bias.

Kernel: ttts_tpu_torch/csrc/attention.cu, replacing ttts_tpu/ops/pallas/
attention.py (flash_attention in its bias, non-causal mode). The bias is
given as its (H, 2T-1) diagonal strip: bias[h, i, j] = strip[h, j-i+T-1].
"""

from __future__ import annotations

import math

import torch

from ttts_tpu_torch.ops.cuda import _build


def toeplitz_bias(strip: torch.Tensor, t: int) -> torch.Tensor:
    """(H, 2T-1) strip → (H, T, T) bias."""
    r = torch.arange(t, device=strip.device)
    return strip[:, r[None, :] - r[:, None] + t - 1]


def flash_attention_plain(q, k, v, strip):
    """q, k, v: (B, T, H, D); strip: (H, 2T-1). f32 scores and softmax, the
    scale 1/sqrt(D) folded into q in q's dtype, as the TPU kernel does →
    (B, T, H, D)."""
    t, d = q.shape[1], q.shape[3]
    qs = (q.float() * (1.0 / math.sqrt(d))).to(q.dtype).float()
    s = torch.einsum("bthd,bshd->bhts", qs, k.float())
    s = s + toeplitz_bias(strip.float(), t)[None]
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bshd->bthd", p, v.float()).to(q.dtype)


def _row_stride(x: torch.Tensor, name: str) -> int:
    b, t, h, d = x.shape
    rs = x.stride(2)
    if x.stride() != (t * h * rs, h * rs, rs, 1) or rs % 8 or x.data_ptr() % 16:
        raise ValueError(f"flash_attention: {name} must be (B, T, H, D) rows of "
                         f"contiguous D with a 16-byte aligned row stride, got "
                         f"strides {x.stride()}")
    return rs


def flash_attention(q, k, v, strip) -> torch.Tensor:
    """See flash_attention_plain. On CUDA q, k, v are bf16 with D in {32, 64};
    they may be strided views of one fused (B, T, H, 3D) qkv tensor."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, strip)
    if q.device.type != "cuda" or any(x.device != q.device for x in (k, v, strip)):
        raise ValueError("flash_attention: all tensors must be on one CUDA device")
    if any(x.dtype != torch.bfloat16 for x in (q, k, v)):
        raise TypeError("flash_attention: the kernel takes bfloat16 q, k, v")
    b, t, h, d = q.shape
    if k.shape != q.shape or v.shape != q.shape or d not in (32, 64):
        raise ValueError(f"flash_attention: unsupported shapes {tuple(q.shape)}")
    if strip.shape != (h, 2 * t - 1):
        raise ValueError(f"flash_attention: strip {tuple(strip.shape)} != {(h, 2 * t - 1)}")
    strip = strip.float().contiguous()
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    _build.launch("ttts_flash_bias_attention", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), strip.data_ptr(), out.data_ptr(), b, t, h, d,
                  _row_stride(q, "q"), _row_stride(k, "k"), _row_stride(v, "v"),
                  strip.stride(0), 1.0 / math.sqrt(d))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
