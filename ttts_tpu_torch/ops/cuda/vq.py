"""VQ codebook nearest neighbour.

Kernel: ttts_tpu_torch/csrc/vq.cu, replacing ttts_tpu/ops/pallas/vq.py
(vq_nearest_pallas): one launch of clusters of 8 code slices per 32-row
tile, x and the codebook brought in by TMA, merged through distributed shared
memory. The kernel drops the row-constant ||x||^2 that the plain version
keeps, so the two may disagree only where two codes' distances tie to within
float rounding.
"""

from __future__ import annotations

import torch

from ttts_tpu_torch.ops.cuda import _build

_CHUNK = 32  # VQ_CHUNK in vq.cu: D must be a multiple of it


def vq_nearest_plain(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """argmin_j ||x_i - e_j||^2 in f32 → (N,) int32 (ttts_tpu/models/
    quantize.py _nearest). Ties go to the lowest index."""
    dist = ((x * x).sum(1, keepdim=True) - 2.0 * (x @ codebook.T)
            + (codebook * codebook).sum(1)[None])
    return torch.argmin(dist, dim=-1).to(torch.int32)


def vq_nearest(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """x (N, D) f32, codebook (bins, D) f32 → (N,) int32 nearest-code index.
    On CUDA D is a multiple of 32 and both tensors 16-byte aligned."""
    if x.device.type == "cpu":
        return vq_nearest_plain(x, codebook)
    if x.device.type != "cuda" or codebook.device != x.device:
        raise ValueError(f"vq_nearest: x on {x.device}, codebook on {codebook.device}")
    if x.dtype != torch.float32 or codebook.dtype != torch.float32:
        raise TypeError("vq_nearest: the kernel takes float32 x and codebook")
    n, d = x.shape
    bins, d2 = codebook.shape
    x, codebook = x.contiguous(), codebook.contiguous()
    if d != d2 or d % _CHUNK or bins < 1 or x.data_ptr() % 16 or codebook.data_ptr() % 16:
        raise ValueError(f"vq_nearest: unsupported x {tuple(x.shape)}, codebook "
                         f"{tuple(codebook.shape)} (D a multiple of {_CHUNK}, "
                         "16-byte aligned tensors)")
    out = torch.empty(n, dtype=torch.int32, device=x.device)
    if n:
        _build.launch("ttts_vq_nearest", x.data_ptr(), codebook.data_ptr(), out.data_ptr(),
                      n, d, bins)
        vq_nearest.launches += 1
    return out


vq_nearest.launches = 0
