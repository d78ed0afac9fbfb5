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

The GPT's training route (GPTConfig.flash_attention), FlashCausal: a causal
forward that also saves each row's log-sum-exp, csrc/attention_fwd.cu
(flash_causal_forward, mode "causal_lse" of the same counts), and its
backward, csrc/attention_bwd.cu (flash_causal_backward, mode "causal_bwd": a
dQ kernel, then a dK/dV kernel, two launches a call), replacing the library
kernel behind ttts_tpu/models/gpt.py _flash_causal_attention
(jax.experimental.pallas.ops.tpu.flash_attention, forward and backward).
The statistic is in log2 units: lse2 = log2(e) * logsumexp_j(q.k_j /
sqrt(D)).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ttts_tpu_torch.ops.cuda import _build

# (has a bias strip, causal) → the mode's name in `flash_attention.launches`
MODES = {(True, False): "bias", (False, False): "nobias", (False, True): "causal",
         (True, True): "bias_causal"}
LOG2E = 1.4426950408889634


def toeplitz_bias(strip: torch.Tensor, t: int) -> torch.Tensor:
    """(H, 2T-1) strip → (H, T, T) bias: row i is strip[:, T-1-i : 2T-1-i],
    a window of the strip (unfold, whose backward sums in a fixed order, so
    that a training step through the plain version repeats bit for bit)."""
    return strip.unfold(1, t, 1).flip(1)


def _scores(q, k, strip=None, causal: bool = False):
    """Scores (B, H, T, T) of q * 1/sqrt(D) (rounded to q's dtype, as the
    kernel folds the scale into q) against k in f32 (autocast's dtype under
    autocast), plus the strip's bias, keys j > i filled with the scores'
    dtype minimum when causal."""
    t, d = q.shape[1], q.shape[3]
    qs = (q.float() * (1.0 / math.sqrt(d))).to(q.dtype).float()
    s = torch.einsum("bthd,bshd->bhts", qs, k.float())
    if strip is not None:
        s = s + toeplitz_bias(strip.float(), t)[None]
    if causal:
        keep = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, torch.finfo(s.dtype).min)
    return s


def flash_attention_plain(q, k, v, strip=None, causal: bool = False):
    """q, k, v: (B, T, H, D); strip: (H, 2T-1) or None. f32 scores and
    softmax, the scale 1/sqrt(D) folded into q in q's dtype, keys j > i
    filled with the f32 minimum when causal, as the TPU kernel does →
    (B, T, H, D). Under autocast the two products take autocast's dtype
    (the scores' minimum then is that dtype's), as the JAX package's bf16
    training einsums do."""
    p = torch.softmax(_scores(q, k, strip, causal), dim=-1)
    return torch.einsum("bhts,bshd->bthd", p, v.float()).to(q.dtype)


def _strides(x: torch.Tensor, name: str):
    """(token stride, head stride) of a (B, T, H, D) view whose D is
    contiguous and whose batch stride is T times its token stride."""
    b, t, h, d = x.shape
    st, sh = x.stride(1), x.stride(2)
    if t == 1:  # a one-token view's token stride is arbitrary: its batch stride is the one read
        st = x.stride(0) if b > 1 else h * sh
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


def flash_attention(q, k, v, strip=None, causal: bool = False):
    """See flash_attention_plain. On CUDA the inputs are in the kernel's
    domain (kernel_fits): bf16 q, k, v with D in {32, 64}, each possibly a
    strided view of a fused qkv tensor that `_strides` accepts, and none
    requires grad under grad mode (the wrapper records no graph)."""
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
                  strip_ptr, out.data_ptr(), b, t, h, d, *_strides(q, "q"), *_strides(k, "k"),
                  *_strides(v, "v"), strip_stride, int(causal), 1.0 / math.sqrt(d))
    flash_attention.launches[MODES[strip is not None, bool(causal)]] += 1
    return out


# the serving modes, and the training route's: "causal_lse"
# (flash_causal_forward) and "causal_bwd" (flash_causal_backward's two kernels)
flash_attention.launches = dict.fromkeys((*MODES.values(), "causal_lse", "causal_bwd"), 0)


# ------------------------------------------------- the GPT's training route


def flash_causal_forward_plain(q, k, v):
    """q, k, v (B, T, H, D) → (O (B, T, H, D) in q's dtype, lse2 (B, H, T)
    f32): causal softmax attention in f32 and each row's log2-sum-exp2 of
    its scores in log2 units, log2(e) * logsumexp_j(s_ij)."""
    s = _scores(q, k, causal=True)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhts,bshd->bthd", p, v.float()).to(q.dtype)
    return o, lse * LOG2E


def flash_causal_backward_plain(q, k, v, o, lse, do):
    """The causal attention's VJP from the forward's O and lse2, by the
    explicit formulas the kernels follow (no autograd), in f32:
    di = rowsum(dO * O), P = exp2(log2(e) S - lse2) with S = scale Q K^T,
    dV = P^T dO, dP = dO V^T, dS = P * (dP - di), dQ = scale dS K,
    dK = scale dS^T Q → (dq, dk, dv) (B, T, H, D) in q's dtype."""
    scale = 1.0 / math.sqrt(q.shape[3])
    p = torch.exp2(_scores(q, k, causal=True) * LOG2E - lse[..., None])
    dof = do.float()
    di = (dof * o.float()).sum(-1).transpose(1, 2)
    dv = torch.einsum("bhts,bthd->bshd", p, dof)
    ds = p * (torch.einsum("bthd,bshd->bhts", dof, v.float()) - di[..., None])
    dq = torch.einsum("bhts,bshd->bthd", ds, k.float()) * scale
    dk = torch.einsum("bhts,bthd->bshd", ds, q.float()) * scale
    return tuple(x.to(q.dtype) for x in (dq, dk, dv))


def flash_causal_forward(q, k, v):
    """See flash_causal_forward_plain → (O (B, T, H, D), lse2 (B, H, T)
    f32). On CUDA one launch of csrc/attention_fwd.cu (counted under
    "causal_lse"): q, k, v in the kernel's domain (kernel_fits) as views
    that `_strides` accepts, none requiring grad under grad mode."""
    if q.device.type == "cpu":
        return flash_causal_forward_plain(q, k, v)
    _build.refuse_grad("flash_causal_forward", q, k, v)
    if q.device.type != "cuda" or any(x.device != q.device for x in (k, v)):
        raise ValueError("flash_causal_forward: all tensors must be on one CUDA device")
    why = _unsupported(q, k, v)
    if why:
        raise ValueError(f"flash_causal_forward: {why}")
    b, t, h, d = q.shape
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    _build.launch("ttts_flash_causal_forward", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), lse.data_ptr(), b, t, h, d, *_strides(q, "q"),
                  *_strides(k, "k"), *_strides(v, "v"), 1.0 / math.sqrt(d))
    flash_attention.launches["causal_lse"] += 1
    return out, lse


def flash_causal_backward(q, k, v, o, lse, do) -> torch.Tensor:
    """See flash_causal_backward_plain → the gradient of a fused [q; k; v]
    projection: one (B, T, 3 H D) tensor whose column blocks are dq, dk
    and dv (split_qkv gives them). On CUDA the dQ kernel, then the dK/dV
    kernel (two launches, counted under "causal_bwd"): q, k, v in the
    kernel's domain (kernel_fits) as views that `_strides` accepts; o, do
    (B, T, H, D) bf16 (made contiguous); lse the forward's (B, H, T) f32;
    none requiring grad under grad mode."""
    b, t, h, d = q.shape
    if q.device.type == "cpu":
        grads = flash_causal_backward_plain(q, k, v, o, lse, do)
        return torch.cat([g.reshape(b, t, h * d) for g in grads], -1)
    _build.refuse_grad("flash_causal_backward", q, k, v, o, lse, do)
    if any(x.device != q.device for x in (k, v, o, lse, do)) or q.device.type != "cuda":
        raise ValueError("flash_causal_backward: all tensors must be on one CUDA device")
    why = _unsupported(q, k, v) or _unsupported(o, do, q)
    if why:
        raise ValueError(f"flash_causal_backward: {why}")
    if lse.shape != (b, h, t) or lse.dtype != torch.float32:
        raise ValueError(f"flash_causal_backward: lse {tuple(lse.shape)} {lse.dtype} != "
                         f"{(b, h, t)} float32")
    o, do, lse = o.contiguous(), do.contiguous(), lse.contiguous()
    if o.data_ptr() % 16 or do.data_ptr() % 16:  # read by TMA and 16-byte loads
        raise ValueError("flash_causal_backward: o and do must be 16-byte aligned")
    grad = torch.empty((b, t, 3 * h * d), dtype=q.dtype, device=q.device)
    di = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    ptr, step = grad.data_ptr(), h * d * grad.element_size()
    _build.launch("ttts_flash_causal_backward", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  o.data_ptr(), do.data_ptr(), lse.data_ptr(), di.data_ptr(), ptr, ptr + step,
                  ptr + 2 * step, b, t, h, d, *_strides(q, "q"), *_strides(k, "k"),
                  *_strides(v, "v"), 3 * h * d, 1.0 / math.sqrt(d))
    flash_attention.launches["causal_bwd"] += 2  # flash_bwd_dq_sm90, then flash_bwd_dkv_sm90
    return grad


def split_qkv(qkv: torch.Tensor, heads: int):
    """The (B, T, H, D) q, k, v views of a fused (B, T, 3 H D) projection."""
    b, t, n = qkv.shape
    return tuple(z.view(b, t, heads, n // (3 * heads)) for z in qkv.split(n // 3, dim=-1))


class FlashCausal(torch.autograd.Function):
    """Causal self-attention over a fused (B, T, 3 H D) [q; k; v]
    projection → (B, T, H D): the GPT's training route, differentiable.
    Forward: flash_causal_forward, saving O and lse2; backward:
    flash_causal_backward into one (B, T, 3 H D) gradient. CPU tensors take
    the plain versions. Elsewhere the kernels run, and an input outside
    their domain (f32 compute, a head dim other than 32 or 64), a build or
    a launch failure raises. The backward runs under the forward's autocast
    state (custom_bwd)."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, qkv, heads: int):
        q, k, v = split_qkv(qkv, heads)
        why = qkv.device.type != "cpu" and _unsupported(q, k, v)
        if why:
            raise ValueError(f"gpt.flash_attention: {why}. On the card the route runs its "
                             "kernels only: train with train.amp on (bf16 autocast) and a "
                             "head dim of 32 or 64, or turn gpt.flash_attention off")
        o, lse = flash_causal_forward(q, k, v)
        ctx.heads = heads
        ctx.save_for_backward(qkv, o, lse)
        b, t, h, d = o.shape
        return o.reshape(b, t, h * d)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, grad):
        qkv, o, lse = ctx.saved_tensors
        do = grad.reshape(o.shape).to(o.dtype)
        return flash_causal_backward(*split_qkv(qkv, ctx.heads), o, lse, do), None
