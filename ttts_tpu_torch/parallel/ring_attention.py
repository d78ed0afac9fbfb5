"""Ring attention: sequence-parallel exact attention over a process group,
port of ttts_tpu/parallel/ring_attention.py.

The sequence axis of q/k/v is cut into one chunk per rank of the group. q
stays; k/v blocks travel around the ring, one hop per step, sent to the
next rank and received from the previous one in one batch_isend_irecv
(both posted together, so no rank waits on another's send), while the
streaming softmax (flash-style) partials accumulate in f32. Each rank holds
O(T/n · T/n) scores instead of O(T²). The arithmetic of a hop is plain
PyTorch, as the JAX package's is plain jnp: no kernel runs here, and the
collectives run outside every kernel.

    ring = make_ring_attention(mesh, "sp", causal=False, with_bias=True)
    out = ring(q, k, v, strip)          # full (B, T, H, D) on every rank
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from ttts_tpu_torch.parallel.mesh import all_gather


def _pass_on(k: torch.Tensor, v: torch.Tensor, group, rank: int, n: int):
    """Send k, v to rank + 1 and receive the previous rank's (ring order)."""
    nxt = dist.get_global_rank(group, (rank + 1) % n)
    prv = dist.get_global_rank(group, (rank - 1) % n)
    k_in, v_in = torch.empty_like(k), torch.empty_like(v)
    ops = [dist.P2POp(dist.isend, k, nxt, group), dist.P2POp(dist.isend, v, nxt, group),
           dist.P2POp(dist.irecv, k_in, prv, group), dist.P2POp(dist.irecv, v_in, prv, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return k_in, v_in


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                   causal: bool = False, scale: Optional[float] = None,
                   bias_strip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Local blocks q/k/v (B, T/n, H, D) of this rank's chunk of the
    sequence (rank r holds positions [r T/n, (r+1) T/n)) → the exact
    attention of the local queries over the whole sequence, (B, T/n, H, D)
    in q's dtype.

    `bias_strip` (H, 2T-1), the same on every rank: the Toeplitz relative-
    position bias in strip form, bias[h, i, j] = strip[h, j-i+T-1], added to
    the scaled scores (the AttentionBlock convention); each hop gathers only
    its (Tq, Tk) window of diagonals."""
    b, t_local, h, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    dev = q.device
    q_pos = rank * t_local + torch.arange(t_local, device=dev)
    t_global = n * t_local
    qf = q.float()
    strip = None if bias_strip is None else bias_strip.float()
    # masked scores are -inf (not the f32 minimum), so that isfinite below
    # tells masked entries from valid ones
    acc = torch.zeros(b, h, t_local, d, dtype=torch.float32, device=dev)
    m = torch.full((b, h, t_local), -math.inf, dtype=torch.float32, device=dev)
    l = torch.zeros(b, h, t_local, dtype=torch.float32, device=dev)
    k_cur, v_cur = k.contiguous(), v.contiguous()
    for step in range(n):
        # the block held at `step` started on rank (rank - step) % n
        src = (rank - step) % n
        k_pos = src * t_local + torch.arange(t_local, device=dev)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k_cur.float()) * scale
        if strip is not None:
            rel = k_pos[None, :] - q_pos[:, None] + (t_global - 1)  # (Tq, Tk)
            s = s + strip[:, rel][None]
        if causal:
            s = s.masked_fill(~(q_pos[:, None] >= k_pos[None, :]), -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # fully masked rows: -inf - -inf = nan → zero them
        p = torch.exp(s - m_new[..., None])
        p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
        corr = torch.exp(m - m_new)
        corr = torch.where(torch.isfinite(m), corr, torch.zeros_like(corr))
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v_cur.float())
        m = m_new
        if step < n - 1:  # the last block needs no further hop
            k_cur, v_cur = _pass_on(k_cur, v_cur, group, rank, n)
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def make_ring_attention(mesh, axis_name: str = "sp", causal: bool = False,
                        with_bias: bool = False, scale: Optional[float] = None):
    """Ring attention over axis `axis_name` of `mesh` for full inputs: the
    callable takes (B, T, H, D) q, k, v (and, with `with_bias`, the (H,
    2T-1) strip), T divisible by the axis size, runs ring_attention on
    this rank's T-chunk and all-gathers the output chunks, so every rank
    returns the full (B, T, H, D) output (shard_map's out_specs in the JAX
    package)."""
    group = mesh.get_group(axis_name)
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)

    def ring(q, k, v, strip=None):
        t = q.shape[1]
        if t % n:
            raise ValueError(f"ring attention: T={t} does not divide over {n} ranks")
        if with_bias != (strip is not None):
            raise ValueError("ring attention: pass the strip exactly when with_bias is set")
        c = t // n
        chunk = [x[:, rank * c:(rank + 1) * c] for x in (q, k, v)]
        out = ring_attention(*chunk, group, causal=causal, scale=scale, bias_strip=strip)
        return all_gather(out, group, 1)

    return ring
