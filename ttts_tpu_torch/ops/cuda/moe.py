"""Grouped SwiGLU experts of a mixture-of-experts layer.

Kernel: ttts_tpu_torch/csrc/moe_experts.cu. It replaces no TPU kernel: the
JAX package has no mixture-of-experts layer. It serves the routed experts
of the MLA-MoE trunk (models/mla_moe.py): the (token, expert) pairs of a
layer sorted by expert, xs (P, D), each expert's rows contiguous, and the
experts' weights stacked, gate and up as gate_up (E, 2F, D), down (E, D, F),
in nn.Linear's (out, in) layout:

    y[r] = ws[r] * down_e(silu(gate_e xs[r]) * up_e xs[r])   for r in expert e's rows

with h = silu(.) * (.) rounded to xs's dtype between the two products, the
sums and y in f32.

The group sizes `counts` (E,) int32 stay on the device: the kernel reads
them and works out each expert's rows there, so its grid depends only on P
and E, and one launch, captured once in a CUDA graph, serves every step's
routing (models/gpt.inference_speech). `moe_experts.stats` holds, per
device and P, an int64 pair on that device, [pairs, experts with at least
one pair], which every call adds to without a synchronise; `counters()`
reads them once.

The plain version loops over the experts with their rows sliced on the
host (the counts read there); the wrapper takes it only for CPU tensors.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ttts_tpu_torch.ops.cuda import _build

GATE_UP_N = 128  # h columns of a gate/up block: F a multiple of it
DOWN_N = 256  # output columns of a down block: D a multiple of it
MAX_EXPERTS = 256


def _stats(dev: torch.device, pairs: int) -> torch.Tensor:
    """The [pairs, experts read] counter of calls of `pairs` rows on `dev`,
    made at the first such call (never while a CUDA graph captures: a
    graph's warm-up call makes it)."""
    key = (str(dev), pairs)
    t = moe_experts.stats.get(key)
    if t is None:
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("moe_experts: the first call of a shape runs before its capture")
        t = moe_experts.stats[key] = torch.zeros(2, dtype=torch.int64, device=dev)
    return t


def counters() -> Dict[str, object]:
    """{"moe.pairs": n, "moe.experts_read": n, "by_pairs": {P: [pairs,
    experts read]}} summed over devices, read now (a synchronise on the
    card)."""
    by: Dict[int, list] = {}
    for (_, p), t in moe_experts.stats.items():
        pairs, read = (int(v) for v in t.tolist())
        acc = by.setdefault(p, [0, 0])
        acc[0] += pairs
        acc[1] += read
    return {"moe.pairs": sum(v[0] for v in by.values()),
            "moe.experts_read": sum(v[1] for v in by.values()), "by_pairs": by}


def moe_experts_plain(xs, counts, gate_up, down, ws) -> torch.Tensor:
    """xs (P, D) sorted by expert, counts (E,) int32 summing to P, gate_up
    (E, 2F, D), down (E, D, F), ws (P,) f32 → y (P, D) f32 (see the module
    docstring)."""
    p, d = xs.shape
    f = down.shape[2]
    y = torch.zeros(p, d, dtype=torch.float32, device=xs.device)
    sizes = counts.tolist()
    at = 0
    for e, n in enumerate(sizes):
        if n:
            x = xs[at: at + n].float()
            g, u = (x @ gate_up[e].float().t()).split(f, dim=-1)
            h = (F.silu(g) * u).to(xs.dtype).float()
            y[at: at + n] = (h @ down[e].float().t()) * ws[at: at + n, None].float()
        at += n
    stats = _stats(xs.device, p)
    stats += torch.tensor([p, sum(1 for n in sizes if n)], dtype=torch.int64,
                          device=stats.device)
    return y


def moe_experts(xs, counts, gate_up, down, ws) -> torch.Tensor:
    """The grouped experts; see moe_experts_plain. On CUDA: bf16 xs and
    weights, int32 counts, f32 ws, D a multiple of 256 and F of 128, at
    most 256 experts, and no input requiring grad under grad mode (the
    kernel has no backward). Each call launches two kernels (gate/up, then
    down) and counts one in `moe_experts.launches`."""
    if xs.device.type == "cpu":
        return moe_experts_plain(xs, counts, gate_up, down, ws)
    tensors = (xs, counts, gate_up, down, ws)
    _build.refuse_grad("moe_experts", *tensors)
    if xs.device.type != "cuda" or any(t.device != xs.device for t in tensors):
        raise ValueError("moe_experts: all tensors must be on one CUDA device")
    if (xs.dtype, gate_up.dtype, down.dtype, counts.dtype, ws.dtype) != (
            torch.bfloat16, torch.bfloat16, torch.bfloat16, torch.int32, torch.float32):
        raise ValueError("moe_experts: bf16 xs and experts, int32 counts, f32 ws")
    p, d = xs.shape
    e, f2, d2 = gate_up.shape
    f = f2 // 2
    if (d2 != d or down.shape != (e, d, f) or counts.shape != (e,) or ws.shape != (p,)
            or d % DOWN_N or f % GATE_UP_N or not 0 < e <= MAX_EXPERTS or p == 0):
        raise ValueError(f"moe_experts: bad shapes xs {tuple(xs.shape)}, gate_up "
                         f"{tuple(gate_up.shape)}, down {tuple(down.shape)}, counts "
                         f"{tuple(counts.shape)}, ws {tuple(ws.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("moe_experts: tensors must be contiguous")
    h = torch.empty(p, f, dtype=torch.bfloat16, device=xs.device)
    y = torch.empty(p, d, dtype=torch.float32, device=xs.device)
    stats = _stats(xs.device, p)
    ptrs = (xs, gate_up, down, counts, ws, h, y, stats)
    if any(t.data_ptr() % 16 for t in ptrs):  # TMA's and the stores' alignment
        raise ValueError("moe_experts: tensors must be 16-byte aligned")
    _build.launch("ttts_moe_experts", *(t.data_ptr() for t in ptrs), p, e, d, f)
    moe_experts.launches += 1
    return y


moe_experts.launches = 0
moe_experts.stats = {}  # (device, P) → int64 [pairs, experts read] on that device

