"""VQ codebook nearest neighbour.

Kernel: ttts_tpu_torch/csrc/vq.cu, replacing ttts_tpu/ops/pallas/vq.py
(vq_nearest_pallas). The kernel drops the row-constant ||x||^2 that the plain
version keeps, so the two may disagree only where two codes' distances tie
to within float rounding.
"""

from __future__ import annotations

import torch

from ttts_tpu_torch.ops.cuda import _build

_MAX_SMEM = 48 * 1024
_ROWS = 8  # VQ_ROWS in vq.cu


def vq_nearest_plain(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """argmin_j ||x_i - e_j||^2 in f32 → (N,) int32 (ttts_tpu/models/
    quantize.py _nearest). Ties go to the lowest index."""
    dist = ((x * x).sum(1, keepdim=True) - 2.0 * (x @ codebook.T)
            + (codebook * codebook).sum(1)[None])
    return torch.argmin(dist, dim=-1).to(torch.int32)


def vq_nearest(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """x (N, D) f32, codebook (bins, D) f32 → (N,) int32 nearest-code index."""
    if x.device.type == "cpu":
        return vq_nearest_plain(x, codebook)
    if x.device.type != "cuda" or codebook.device != x.device:
        raise ValueError(f"vq_nearest: x on {x.device}, codebook on {codebook.device}")
    if x.dtype != torch.float32 or codebook.dtype != torch.float32:
        raise TypeError("vq_nearest: the kernel takes float32 x and codebook")
    n, d = x.shape
    bins, d2 = codebook.shape
    if d != d2 or _ROWS * d * 4 > _MAX_SMEM:
        raise ValueError(f"vq_nearest: bad shapes x {tuple(x.shape)}, "
                         f"codebook {tuple(codebook.shape)}")
    x = x.contiguous()
    cbt = codebook.t().contiguous()  # (D, bins): a warp reads 32 consecutive codes
    keys = torch.empty(n, dtype=torch.int64, device=x.device)  # per-row (distance, index)
    out = torch.empty(n, dtype=torch.int32, device=x.device)
    _build.launch("ttts_vq_nearest", x.data_ptr(), cbt.data_ptr(), keys.data_ptr(),
                  out.data_ptr(), n, d, bins)
    vq_nearest.launches += 1
    return out


vq_nearest.launches = 0
