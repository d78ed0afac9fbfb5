"""Residual vector quantization with EMA codebooks, port of ttts_tpu/models/
quantize.py: the serving half (`nearest`, `rvq_encode`, `rvq_quantize` =
the eval forward, `rvq_decode`) and the training half (`rvq_init`,
`_sample_vectors`, `_kmeans`, `_layer_update`, `rvq_forward`).

Training semantics (EnCodec's EuclideanCodebook, ttts/vqvae/core_vq.py,
with the JAX package's two fixes): EMA decay 0.99, Laplace smoothing 1e-5,
k-means on the first training batch (farthest-point or uniform seeding,
500-sample cap, the next layer initialised on this layer's residuals),
`embed_avg = embed * cluster_size` at init, dead-code expiry below a cluster
size of 2 that also resets `embed_avg` and `cluster_size`, the
straight-through estimator and the commitment loss (the mean over layers)
taken from the codebook *before* this step's update.

Every nearest-code search (the per-layer search and the k-means init's
residual pass) takes detached inputs under no_grad, so that on the card it
runs the VQ kernel (ops/cuda/vq.py), whose dispatch takes the plain version
whenever autograd would record the call; the codes are integral, as JAX's
stop_gradient makes them. The k-means iterations keep their own f32
product, as JAX's `_kmeans` does. The codebook update works on detached
tensors outside the graph. The draws (k-means seeds, expiry replacements)
come from an explicit torch.Generator (`vq_draws`) or are injected.

Data parallel (`mesh`, parallel.make_mesh's; JAX's axis_name path,
quantize.py:186-229, 269-317): each rank holds its rows of the batch. The
per-layer statistics (onehot sums, onehot.T @ x) are summed over the batch
ranks, and the k-means init and the dead-code replacements draw from the
pool of every rank's rows, all-gathered in rank order (`gather_batch`),
with the global batch's draws; so every rank holds the same codebook after
every step. The search itself stays each rank's, through the kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ttts_tpu_torch.ops.cuda import vq
from ttts_tpu_torch.parallel.mesh import all_reduce, batch_groups, data_axis_size, gather_batch

KMEANS_SAMPLES = 500  # the k-means sample cap (core_vq.py:71-93)


def nearest(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """argmin_j ||x_i - e_j||^2 → (N,) int64. x (N, D), embed (bins, D).
    The VQ kernel where its domain holds (vq.kernel_fits: D a multiple of
    32), else its plain version, as ttts_tpu's _nearest gates the Pallas
    kernel."""
    return vq.nearest(x.float(), embed.float()).long()


def rvq_encode(embed: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """embed (n_q, bins, D); x (B, T, D) → codes (n_q, B, T)."""
    return rvq_quantize(embed, x)[1]


def rvq_quantize(embed: torch.Tensor, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The eval forward (JAX's rvq_forward with train=False): embed (n_q, bins, D);
    x (B, T, D) → (quantized (B, T, D) = the sum of each layer's chosen
    codes, codes (n_q, B, T))."""
    b, t, d = x.shape
    residual = x.reshape(-1, d)
    quantized = torch.zeros_like(residual)
    codes = []
    for layer in embed:
        idx = nearest(residual, layer)
        quant = layer[idx]
        codes.append(idx.reshape(b, t))
        residual = residual - quant
        quantized = quantized + quant
    return quantized.reshape(b, t, d), torch.stack(codes)


def rvq_decode(embed: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """codes (n_q, B, T) → (B, T, D): the sum of each layer's codes."""
    out = torch.zeros(codes.shape[1:] + (embed.shape[-1],), dtype=embed.dtype,
                      device=embed.device)
    for layer, idx in zip(embed, codes):
        out = out + layer[idx]
    return out


# ------------------------------------------------------------------ training


@dataclass
class RVQState:
    """EMA codebook state of every layer: embed, embed_avg (n_q, bins, D),
    cluster_size (n_q, bins), inited () bool (False until the k-means init
    on the first training batch)."""

    embed: torch.Tensor
    embed_avg: torch.Tensor
    cluster_size: torch.Tensor
    inited: torch.Tensor


def rvq_init(n_q: int, bins: int, dim: int, device=None) -> RVQState:
    """The state a training run starts from: zeros and inited False,
    waiting for the k-means init of the first training batch."""
    embed = torch.zeros(n_q, bins, dim, device=device)
    return RVQState(embed=embed, embed_avg=embed.clone(),
                    cluster_size=torch.zeros(n_q, bins, device=device),
                    inited=torch.tensor(False, device=device))


def sample_indices(n: int, num: int, generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """`num` row indices of `n` (sample_vectors, core_vq.py:60-68): a random
    permutation's first `num` when n >= num, else `num` draws with
    replacement."""
    if n >= num:
        return torch.randperm(n, generator=generator)[:num]
    return torch.randint(0, n, (num,), generator=generator)


def _sample_vectors(samples: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return samples[idx.to(samples.device)]


def vq_draws(n_rows: int, n_q: int, bins: int, seeding: str = "farthest_point",
             generator: Optional[torch.Generator] = None) -> Dict[str, List[torch.Tensor]]:
    """One training forward's draws for N = `n_rows` rows (CPU tensors):
    per layer, the k-means seed (farthest_point: the first mean's row, 0-d;
    uniform: `bins` rows of the min(N, 500) samples) and the `bins` expiry
    replacement rows of the layer's N residuals. JAX draws them from
    fold_in(key, 1000 + i) and fold_in(key, i) (quantize.py:289, 341)."""
    n_km = min(n_rows, KMEANS_SAMPLES)
    if seeding == "farthest_point":
        kmeans = [torch.randint(0, n_km, (), generator=generator) for _ in range(n_q)]
    elif seeding == "uniform":
        kmeans = [sample_indices(n_km, bins, generator) for _ in range(n_q)]
    else:
        raise NotImplementedError(f"unknown k-means seeding {seeding!r}")
    replace = [sample_indices(n_rows, bins, generator) for _ in range(n_q)]
    return {"kmeans": kmeans, "replace": replace}


def _sq_dists(samples: torch.Tensor, means: torch.Tensor) -> torch.Tensor:
    return ((samples * samples).sum(-1, keepdim=True) - 2.0 * (samples @ means.T)
            + (means * means).sum(-1)[None, :])


@torch.no_grad()
def _kmeans(samples: torch.Tensor, num_clusters: int, seed: torch.Tensor,
            num_iters: int = 10, seeding: str = "farthest_point"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-means over the first 500 rows (core_vq.py:71-93) → (means
    (num_clusters, D), final assignment counts (num_clusters,) f32). `seed`
    is vq_draws' k-means draw of this layer. Lloyd iterations and the
    empty-cluster rule (an empty cluster keeps its mean) are the
    reference's; ties go to the first index."""
    samples = samples[:KMEANS_SAMPLES]
    if seeding == "uniform":
        means = _sample_vectors(samples, seed)
    elif seeding == "farthest_point":
        means = torch.zeros(num_clusters, samples.shape[-1], dtype=samples.dtype,
                            device=samples.device)
        means[0] = samples[seed.to(samples.device)]
        mind = ((samples - means[0]) ** 2).sum(-1)
        for i in range(1, num_clusters):
            means[i] = samples[torch.argmax(mind)]
            mind = torch.minimum(mind, ((samples - means[i]) ** 2).sum(-1))
    else:
        raise NotImplementedError(f"unknown k-means seeding {seeding!r}")
    for _ in range(num_iters):
        onehot = F.one_hot(torch.argmin(_sq_dists(samples, means), -1),
                           num_clusters).to(samples.dtype)
        counts = onehot.sum(0)
        new_means = (onehot.T @ samples) / counts.clamp_min(1.0)[:, None]
        means = torch.where((counts == 0)[:, None], means, new_means)
    counts = F.one_hot(torch.argmin(_sq_dists(samples, means), -1),
                       num_clusters).float().sum(0)
    return means, counts


@torch.no_grad()
def _layer_update(embed: torch.Tensor, embed_avg: torch.Tensor, cluster_size: torch.Tensor,
                  x: torch.Tensor, onehot: torch.Tensor, replace: torch.Tensor,
                  decay: float, epsilon: float, threshold: float, mesh=None):
    """EMA update and dead-code expiry of one layer (core_vq.py:216-228 with
    the JAX package's expiry fix): x (N, D) its inputs, onehot (N, bins),
    `replace` vq_draws' `bins` replacement rows of the global pool of x.
    → (embed, embed_avg, cluster_size)."""
    bins = embed.shape[0]
    onehot_sum, embed_sum = all_reduce([onehot.sum(0), onehot.T @ x], batch_groups(mesh),
                                       mean=False)
    cluster_size = decay * cluster_size + (1 - decay) * onehot_sum
    embed_avg = decay * embed_avg + (1 - decay) * embed_sum
    expired = cluster_size < threshold
    # under a mesh the pool is every rank's rows, gathered only when a code
    # expired (cluster_size is the same on every rank, so they all agree)
    if mesh is None or bool(expired.any()):
        embed_avg = torch.where(expired[:, None],
                                _sample_vectors(gather_batch(mesh, x), replace), embed_avg)
    cluster_size = torch.where(expired, torch.ones_like(cluster_size), cluster_size)
    n = cluster_size.sum()
    smoothed = (cluster_size + epsilon) / (n + bins * epsilon) * n
    return embed_avg / smoothed[:, None], embed_avg, cluster_size


@torch.no_grad()
def _kmeans_init(state: RVQState, flat: torch.Tensor, draws, seeding: str,
                 mesh=None) -> RVQState:
    """The first training batch's k-means init of every layer, each on the
    previous layer's residuals (quantize.py:278-307), over the global pool
    of the batch's rows."""
    embeds, counts = [], []
    data = gather_batch(mesh, flat.detach())
    for i in range(state.embed.shape[0]):
        m, c = _kmeans(data, state.embed.shape[1], draws["kmeans"][i], seeding=seeding)
        embeds.append(m)
        counts.append(c)
        data = data - m[nearest(data, m)]
    embed, size = torch.stack(embeds), torch.stack(counts)
    return RVQState(embed=embed, embed_avg=embed * size[..., None], cluster_size=size,
                    inited=torch.ones_like(state.inited))


def rvq_forward(state: RVQState, x: torch.Tensor, draws=None, decay: float = 0.99,
                epsilon: float = 1e-5, threshold_ema_dead_code: float = 2.0,
                kmeans_seeding: str = "farthest_point",
                generator: Optional[torch.Generator] = None, mesh=None):
    """The training forward (ResidualVectorQuantizer.forward with train=True,
    quantize.py:70-95): x (B, T, D) → (quantized (B, T, D), codes (n_q, B,
    T), commit loss, new state). `draws` (vq_draws' keys for the global
    batch's rows; drawn from `generator` when None) feed the k-means init,
    when the state is not inited yet, and the expiry. `mesh`: x is this
    rank's rows of the batch (see the module docstring); the commit loss is
    this rank's mean. The eval forward is rvq_quantize."""
    b, t, d = x.shape
    n_q, bins = state.embed.shape[:2]
    flat = x.reshape(-1, d)
    if draws is None:
        n_rows = flat.shape[0] * (1 if mesh is None else data_axis_size(mesh))
        draws = vq_draws(n_rows, n_q, bins, kmeans_seeding, generator)
    if not bool(state.inited):
        state = _kmeans_init(state, flat, draws, kmeans_seeding, mesh)
    quantized = torch.zeros_like(flat)
    residual = flat
    losses, codes, new = [], [], []
    for i in range(n_q):
        with torch.no_grad():
            idx = nearest(residual.detach(), state.embed[i])
        quant = state.embed[i][idx]
        codes.append(idx.reshape(b, t))
        onehot = F.one_hot(idx, bins).to(residual.dtype)
        new.append(_layer_update(state.embed[i], state.embed_avg[i], state.cluster_size[i],
                                 residual.detach(), onehot, draws["replace"][i], decay,
                                 epsilon, threshold_ema_dead_code, mesh))
        losses.append(torch.mean((quant - residual) ** 2))  # commitment (core_vq.py:315)
        quantized = quantized + (residual + (quant - residual).detach())  # straight-through
        residual = residual - quant
    embed, embed_avg, cluster_size = map(torch.stack, zip(*new))
    state = RVQState(embed=embed, embed_avg=embed_avg, cluster_size=cluster_size,
                     inited=state.inited)
    return quantized.reshape(b, t, d), torch.stack(codes), torch.mean(torch.stack(losses)), state
