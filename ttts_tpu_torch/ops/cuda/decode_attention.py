"""Fused single-token decode attention with in-place KV-cache row update.

Kernel: ttts_tpu_torch/csrc/decode_attention.cu, replacing
ttts_tpu/ops/pallas/decode_attention.py (fused_decode_attention): one launch
per step, a cluster of 8 blocks per (batch, head) whose partials merge in
distributed shared memory, so the grid does not depend on `pos` and the
wrapper allocates only the output. The caches use a GPU-natural layout,
(B, H, max_len, dk) per layer, instead of the TPU's lane-packed
(max_len, dk, H*B); both versions write row `pos` in place.
"""

from __future__ import annotations

import math

import torch

from ttts_tpu_torch.ops.cuda import _build

DK = 64  # DEC_DK in decode_attention.cu: the head width the kernel takes


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


def kernel_fits(dtype: torch.dtype, dk: int) -> bool:
    """Whether the kernel's domain holds for q and caches of this dtype and
    head width: bfloat16 and dk = 64. The gate a model takes before any
    launch, as ttts_tpu's decode attention gates its kernel; `pos`, the
    caches' layout and alignment are not part of it (the wrapper raises on
    those)."""
    return dtype == torch.bfloat16 and dk == DK


def pick(dtype: torch.dtype, dk: int, *grad_inputs):
    """The decode-attention function for q and caches of this dtype and head
    width: decode_attention where kernel_fits holds and autograd would not
    record a call on `grad_inputs` (the tensors the step differentiates
    through, if any: q, or the model's parameters; _build.records_grad),
    else its plain version. A decode loop picks once and calls the result
    every step."""
    use = kernel_fits(dtype, dk) and not _build.records_grad(*grad_inputs)
    return decode_attention if use else decode_attention_plain


def decode_attention(q, uk, uv, k_cache, v_cache, pos: int) -> torch.Tensor:
    """One decode-attention step; see decode_attention_plain for shapes. On
    CUDA the dtype and dk are in the kernel's domain (kernel_fits) and no
    input requires grad under grad mode (the kernel has no backward)."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, uk, uv, k_cache, v_cache, pos)
    tensors = (q, uk, uv, k_cache, v_cache)
    _build.refuse_grad("decode_attention", *tensors)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("decode_attention: all tensors must be on one CUDA device")
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise ValueError("decode_attention: the kernel takes bfloat16 q, uk, uv and caches")
    b, h, max_len, dk = k_cache.shape
    if (q.shape != (b, h, dk) or uk.shape != q.shape or uv.shape != q.shape
            or v_cache.shape != k_cache.shape or not 0 <= pos < max_len or dk != DK):
        raise ValueError(f"decode_attention: bad shapes {tuple(k_cache.shape)} (dk must be "
                         f"{DK}) or pos {pos}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("decode_attention: caches must be contiguous (updated in place)")
    q, uk, uv = q.contiguous(), uk.contiguous(), uv.contiguous()
    out = torch.empty_like(q)
    tensors = (q, uk, uv, k_cache, v_cache, out)
    if any(t.data_ptr() % 16 for t in tensors):  # the kernel's 16-byte loads and bulk copies
        raise ValueError("decode_attention: tensors must be 16-byte aligned")
    _build.launch("ttts_decode_attention_bf16", *(t.data_ptr() for t in tensors),
                  b * h, max_len, dk, pos, 1.0 / math.sqrt(dk))
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
