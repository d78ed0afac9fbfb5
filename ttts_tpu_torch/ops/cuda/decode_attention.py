"""Fused single-token decode attention with in-place KV-cache row update.

Kernel: ttts_tpu_torch/csrc/decode_attention.cu, replacing
ttts_tpu/ops/pallas/decode_attention.py (fused_decode_attention). The caches
use a GPU-natural layout, (B, H, max_len, dk) per layer, instead of the TPU's
lane-packed (max_len, dk, H*B); both versions write row `pos` in place.
"""

from __future__ import annotations

import math

import torch

from ttts_tpu_torch.ops.cuda import _build

_CHUNK = 32  # DEC_CHUNK in decode_attention.cu


def decode_attention_plain(q, uk, uv, k_cache, v_cache, pos: int) -> torch.Tensor:
    """q, uk, uv: (B, H, dk); caches: (B, H, max_len, dk), row `pos` written
    in place. Attends over rows <= pos in f32 → (B, H, dk) in q.dtype
    (ttts_tpu decode_attention_reference)."""
    k_cache[:, :, pos] = uk
    v_cache[:, :, pos] = uv
    kc = k_cache[:, :, : pos + 1].float()
    vc = v_cache[:, :, : pos + 1].float()
    s = torch.einsum("bhd,bhmd->bhm", q.float(), kc) / math.sqrt(q.shape[-1])
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhm,bhmd->bhd", p, vc).to(q.dtype)


def decode_attention(q, uk, uv, k_cache, v_cache, pos: int) -> torch.Tensor:
    """One decode-attention step; see decode_attention_plain for shapes."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, uk, uv, k_cache, v_cache, pos)
    tensors = (q, uk, uv, k_cache, v_cache)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("decode_attention: all tensors must be on one CUDA device")
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise TypeError("decode_attention: the kernel takes bfloat16 q, uk, uv and caches")
    b, h, max_len, dk = k_cache.shape
    if (q.shape != (b, h, dk) or uk.shape != q.shape or uv.shape != q.shape
            or v_cache.shape != k_cache.shape or not 0 <= pos < max_len):
        raise ValueError(f"decode_attention: bad shapes or pos {pos}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("decode_attention: caches must be contiguous (updated in place)")
    q, uk, uv = q.contiguous(), uk.contiguous(), uv.contiguous()
    nsplit = pos // _CHUNK + 1
    f32 = dict(dtype=torch.float32, device=q.device)
    m_part = torch.empty(b * h, nsplit, **f32)
    z_part = torch.empty(b * h, nsplit, **f32)
    acc_part = torch.empty(b * h, nsplit, dk, **f32)
    out = torch.empty_like(q)
    _build.launch("ttts_decode_attention_bf16", q.data_ptr(), uk.data_ptr(), uv.data_ptr(),
                  k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
                  m_part.data_ptr(), z_part.data_ptr(), acc_part.data_ptr(),
                  b * h, max_len, dk, pos, 1.0 / math.sqrt(dk))
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
