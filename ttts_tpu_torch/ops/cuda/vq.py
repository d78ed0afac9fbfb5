"""VQ codebook nearest neighbour.

Kernel: ttts_tpu_torch/csrc/vq.cu, replacing ttts_tpu/ops/pallas/vq.py
(vq_nearest_pallas): one launch of clusters of 8 code slices per 40-row
tile (VQ_ROWS), x and the codebook brought in by TMA, merged through
distributed shared memory. The kernel drops the row-constant ||x||^2 that
the plain version keeps, so the two may disagree only where two codes'
distances tie to within float rounding.
"""

from __future__ import annotations

from typing import Optional

import torch

from ttts_tpu_torch.ops.cuda import _build

_CHUNK = 32  # VQ_CHUNK in vq.cu: the floats along D of one TMA box; D a multiple of it


def vq_nearest_plain(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """argmin_j ||x_i - e_j||^2 in f32 → (N,) int32 (ttts_tpu/models/
    quantize.py _nearest). Ties go to the lowest index."""
    dist = ((x * x).sum(1, keepdim=True) - 2.0 * (x @ codebook.T)
            + (codebook * codebook).sum(1)[None])
    return torch.argmin(dist, dim=-1).to(torch.int32)


def _unsupported(x: torch.Tensor, codebook: torch.Tensor) -> Optional[str]:
    """Why the kernel cannot take these dtypes and shapes, or None."""
    if x.dtype != torch.float32 or codebook.dtype != torch.float32:
        return "the kernel takes float32 x and codebook"
    if (x.ndim != 2 or codebook.ndim != 2 or x.shape[1] != codebook.shape[1]
            or x.shape[1] % _CHUNK or codebook.shape[0] < 1):
        return (f"unsupported x {tuple(x.shape)}, codebook {tuple(codebook.shape)} "
                f"(D a multiple of {_CHUNK})")
    return None


def kernel_fits(x: torch.Tensor, codebook: torch.Tensor) -> bool:
    """Whether the kernel's domain holds for these dtypes and shapes: the
    gate `nearest` takes before any launch (ttts_tpu _nearest's)."""
    return _unsupported(x, codebook) is None


def nearest(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """The model call site's search: the kernel where its domain holds
    (kernel_fits) and autograd would not record the call
    (_build.records_grad; the codes are integral, but the rule is every
    dispatch's), else vq_nearest_plain."""
    use = kernel_fits(x, codebook) and not _build.records_grad(x, codebook)
    return (vq_nearest if use else vq_nearest_plain)(x, codebook)


def vq_nearest(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """x (N, D) f32, codebook (bins, D) f32 → (N,) int32 nearest-code index.
    On CUDA the shapes are in the kernel's domain (kernel_fits) and neither
    input requires grad under grad mode."""
    if x.device.type == "cpu":
        return vq_nearest_plain(x, codebook)
    _build.refuse_grad("vq_nearest", x, codebook)
    if x.device.type != "cuda" or codebook.device != x.device:
        raise ValueError(f"vq_nearest: x on {x.device}, codebook on {codebook.device}")
    why = _unsupported(x, codebook)
    if why:
        raise ValueError(f"vq_nearest: {why}")
    x, codebook = x.contiguous(), codebook.contiguous()
    if x.data_ptr() % 16 or codebook.data_ptr() % 16:
        raise ValueError("vq_nearest: x and codebook must be 16-byte aligned")
    out = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    if x.shape[0]:
        _build.launch("ttts_vq_nearest", x.data_ptr(), codebook.data_ptr(), out.data_ptr(),
                      x.shape[0], x.shape[1], codebook.shape[0])
        vq_nearest.launches += 1
    return out


vq_nearest.launches = 0
