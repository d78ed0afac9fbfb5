"""Fused scale-shift ResBlock of the diffusion trunk, and the fused
GroupNorm → qkv projection of its attention blocks.

Kernels: ttts_tpu_torch/csrc/resblock.cu, replacing ttts_tpu/ops/pallas/
resblock.py's two kernels:
  fused_scale_shift_resblock: x + conv3(SiLU(GN(Dense(SiLU(GN(x)*g1 + b1)))
                              *a2 + b2)) + bc3;
  fused_gn_qkv:               (GN(x)*g + b) @ W + bias,
with f32 GroupNorm statistics and matmul operands in x's dtype (f32 sums).
On the card the resblock is five launches: x's GroupNorm partials, the
first activation written once in bf16, the Dense on wgmma (TMA-fed, its
epilogue also giving h's partials), the second activation, and the conv3
as one wgmma GEMM whose taps are TMA loads of a (C, T, B) tensor map, so
rows -1 and T of each batch arrive as zeros. The wrapper allocates h, both
activations and the partials. fused_gn_qkv is three launches: the same
statistics pass, one merge of x's partials into a (B, C) multiply-add, and a
persistent wgmma GEMM fed by TMA that applies it to the raw x on its way
into wgmma's register A operand.
"""

from __future__ import annotations

from typing import Optional

import torch

from ttts_tpu_torch.ops.cuda import _build

_BN = 128  # RB_BN in resblock.cu: output widths must be multiples of it
_BK = 64  # RB_BK in resblock.cu: fused_gn_qkv's C must be a multiple of it
_GN_ROWS, _X_ROWS = 128, 32  # rows of a GroupNorm partial of h and of x (resblock.cu)
_CG = 16  # RB_CG in resblock.cu: channels per group the resblock kernel takes


def _gn(h: torch.Tensor, groups: int, eps: float) -> torch.Tensor:
    b, t, c = h.shape
    g = h.reshape(b, t, groups, c // groups)
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = g.var(dim=(1, 3), keepdim=True, unbiased=False)
    return ((g - mean) * torch.rsqrt(var + eps)).reshape(b, t, c)


def fused_scale_shift_resblock_plain(x, g1, b1, w1, bd1, a2, b2, w3, bc3,
                                     groups: int = 32, eps: float = 1e-5):
    """x (B, T, C); g1, b1, bd1, bc3 (C,); w1 (C, C) as (in, out); a2, b2
    (B, C) — the combined GN_1 x FiLM affine; w3 (3, C, C) as (tap, in, out).
    (ttts_tpu resblock_reference.)"""
    f32, dt = torch.float32, x.dtype
    xf = x.float()
    h = torch.nn.functional.silu(_gn(xf, groups, eps) * g1.float() + b1.float())
    h = h.to(dt).float() @ w1.to(dt).float() + bd1.float()
    h = _gn(h, groups, eps) * a2.float()[:, None] + b2.float()[:, None]
    hb = torch.nn.functional.silu(h).to(dt).float()
    w3c = w3.to(dt).float()
    pad = torch.zeros_like(hb[:, :1])
    y = hb @ w3c[1]
    y = y + torch.cat([pad, hb[:, :-1]], dim=1) @ w3c[0]
    y = y + torch.cat([hb[:, 1:], pad], dim=1) @ w3c[2]
    return (xf + y + bc3.to(f32)).to(dt)


def _resblock_unsupported(x, w1, a2, b2, w3, groups: int) -> Optional[str]:
    """Why the resblock kernel cannot take these dtypes and shapes, or None."""
    if x.dtype != torch.bfloat16 or w1.dtype != x.dtype or w3.dtype != x.dtype:
        return "the kernel takes bfloat16 x, w1, w3"
    b, t, c = x.shape
    if (c % _BN or c > 1024 or c != _CG * groups or w1.shape != (c, c)
            or w3.shape != (3, c, c) or a2.shape != (b, c) or b2.shape != (b, c)):
        return (f"unsupported shapes x {tuple(x.shape)}, groups {groups} (C a multiple of "
                f"{_BN} up to 1024, C / groups = {_CG})")
    return None


def resblock_fits(x, g1, b1, w1, bd1, a2, b2, w3, bc3, groups: int = 32) -> bool:
    """Whether fused_scale_shift_resblock's kernel domain holds for these
    dtypes and shapes: the gate `scale_shift_resblock` takes before any
    launch (ttts_tpu ScaleShiftResBlock._use_fused's)."""
    return _resblock_unsupported(x, w1, a2, b2, w3, groups) is None


def scale_shift_resblock(x, g1, b1, w1, bd1, a2, b2, w3, bc3, groups: int = 32):
    """The model call site's resblock: the kernel where its domain holds
    (resblock_fits) and autograd would not record the call
    (_build.records_grad), else fused_scale_shift_resblock_plain."""
    args = (x, g1, b1, w1, bd1, a2, b2, w3, bc3)
    use = resblock_fits(*args, groups=groups) and not _build.records_grad(*args)
    fn = fused_scale_shift_resblock if use else fused_scale_shift_resblock_plain
    return fn(*args, groups=groups)


def fused_scale_shift_resblock(x, g1, b1, w1, bd1, a2, b2, w3, bc3,
                               groups: int = 32, eps: float = 1e-5):
    """See fused_scale_shift_resblock_plain. On CUDA the shapes are in the
    kernel's domain (resblock_fits): bf16 x, w1 and w3, C a multiple of 128
    (at most 1024) and C / groups = 16, and no input requires grad under
    grad mode (the kernel has no backward)."""
    if x.device.type == "cpu":
        return fused_scale_shift_resblock_plain(x, g1, b1, w1, bd1, a2, b2, w3, bc3,
                                                groups, eps)
    args = (g1, b1, w1, bd1, a2, b2, w3, bc3)
    _build.refuse_grad("fused_scale_shift_resblock", x, *args)
    if x.device.type != "cuda" or any(a.device != x.device for a in args):
        raise ValueError("fused_scale_shift_resblock: all tensors must be on one CUDA device")
    why = _resblock_unsupported(x, w1, a2, b2, w3, groups)
    if why:
        raise ValueError(f"fused_scale_shift_resblock: {why}")
    b, t, c = x.shape
    vec = lambda v: v.float().contiguous()  # noqa: E731
    x, w1, w3 = x.contiguous(), w1.contiguous(), w3.contiguous()
    g1, b1, bd1, bc3, a2, b2 = map(vec, (g1, b1, bd1, bc3, a2, b2))
    f32 = dict(dtype=torch.float32, device=x.device)
    h = torch.empty((b, t, c), **f32)
    acts = torch.empty((2, b, t, c), dtype=x.dtype, device=x.device)  # the two activations
    # GroupNorm partials (mean, M2) per group of x's 32-row and h's 128-row chunks
    part_x = torch.empty((b, groups, -(-t // _X_ROWS), 2), **f32)
    part_h = torch.empty((b, groups, -(-t // _GN_ROWS), 2), **f32)
    out = torch.empty_like(x)
    _build.launch("ttts_resblock", x.data_ptr(), g1.data_ptr(), b1.data_ptr(),
                  w1.data_ptr(), bd1.data_ptr(), a2.data_ptr(), b2.data_ptr(),
                  w3.data_ptr(), bc3.data_ptr(), out.data_ptr(), h.data_ptr(),
                  acts[0].data_ptr(), acts[1].data_ptr(), part_x.data_ptr(),
                  part_h.data_ptr(), b, t, c, groups, eps)
    fused_scale_shift_resblock.launches += 1
    return out


fused_scale_shift_resblock.launches = 0


def fused_gn_qkv_plain(x, g, b, w, bias, groups: int = 32, eps: float = 1e-5):
    """x (B, T, C); g, b (C,) the GroupNorm affine; w (C, K) as (in, out),
    the JAX package's layout (the port's Conv1x1 weight (K, C, 1) transposed);
    bias (K,) → (B, T, K) in x's dtype. The normalised x is rounded to x's
    dtype before the product (ttts_tpu fused_gn_qkv)."""
    dt = x.dtype
    h = (_gn(x.float(), groups, eps) * g.float() + b.float()).to(dt).float()
    return (h @ w.to(dt).float() + bias.float()).to(dt)


def _gn_qkv_unsupported(x, w, bias, groups: int) -> Optional[str]:
    """Why the fused_gn_qkv kernel cannot take these dtypes and shapes, or None."""
    if x.dtype != torch.bfloat16 or w.dtype != x.dtype:
        return "the kernel takes bfloat16 x and w"
    c, k = x.shape[-1], w.shape[1]
    if (c % _BK or c > 1024 or c % (8 * groups) or groups > 64 or k % _BN
            or w.shape != (c, k) or bias.shape != (k,)):
        return (f"unsupported shapes x {tuple(x.shape)}, w {tuple(w.shape)}, groups {groups} "
                f"(C a multiple of {_BK} up to 1024, C / groups a multiple of 8, groups <= 64, "
                f"K a multiple of {_BN})")
    return None


def gn_qkv_fits(x, g, b, w, bias, groups: int = 32) -> bool:
    """Whether fused_gn_qkv's kernel domain holds for these dtypes and
    shapes: the gate `gn_qkv` takes before any launch (ttts_tpu
    AttentionBlock._use_fused_gn's)."""
    return _gn_qkv_unsupported(x, w, bias, groups) is None


def gn_qkv(x, g, b, w, bias, groups: int = 32):
    """The model call site's GroupNorm → qkv: the kernel where its domain
    holds (gn_qkv_fits) and autograd would not record the call
    (_build.records_grad), else fused_gn_qkv_plain."""
    use = gn_qkv_fits(x, g, b, w, bias, groups) and not _build.records_grad(x, g, b, w, bias)
    fn = fused_gn_qkv if use else fused_gn_qkv_plain
    return fn(x, g, b, w, bias, groups=groups)


def fused_gn_qkv(x, g, b, w, bias, groups: int = 32, eps: float = 1e-5):
    """See fused_gn_qkv_plain (w is (in, out)). On CUDA the shapes are in the
    kernel's domain (gn_qkv_fits): bf16 x and w, C a multiple of 64 (at most
    1024), C / groups a multiple of 8, K a multiple of 128 and groups at most
    64, and no input requires grad under grad mode (the kernel has no
    backward)."""
    if x.device.type == "cpu":
        return fused_gn_qkv_plain(x, g, b, w, bias, groups, eps)
    _build.refuse_grad("fused_gn_qkv", x, g, b, w, bias)
    if x.device.type != "cuda" or any(a.device != x.device for a in (g, b, w, bias)):
        raise ValueError("fused_gn_qkv: all tensors must be on one CUDA device")
    why = _gn_qkv_unsupported(x, w, bias, groups)
    if why:
        raise ValueError(f"fused_gn_qkv: {why}")
    bsz, t, c = x.shape
    k = w.shape[1]
    x, w = x.contiguous(), w.contiguous()
    g, b, bias = (v.float().contiguous() for v in (g, b, bias))
    f32 = dict(dtype=torch.float32, device=x.device)
    part = torch.empty((bsz, groups, -(-t // _X_ROWS), 2), **f32)
    table = torch.empty((bsz, c // 2, 4), **f32)  # per channel pair: mul, mul, add, add
    out = torch.empty((bsz, t, k), dtype=x.dtype, device=x.device)
    _build.launch("ttts_gn_qkv", x.data_ptr(), g.data_ptr(), b.data_ptr(), w.data_ptr(),
                  bias.data_ptr(), out.data_ptr(), part.data_ptr(), table.data_ptr(), bsz, t,
                  c, k, groups, eps)
    fused_gn_qkv.launches += 1
    return out


fused_gn_qkv.launches = 0
