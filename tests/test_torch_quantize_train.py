"""PyTorch port parity of the quantizer's training half (ttts_tpu_torch.
models.quantize against ttts_tpu.models.quantize) on the CPU, in f32, at
TINY widths (D = 16, 32 codes), with JAX's draws injected: the k-means
seeds and expiry rows that jax.random gives for fold_in(key, 1000 + i) and
fold_in(key, i) (quantize.py:289, 341), computed here the same way.

- rvq_init (k-means pending), which the training codec's quantizer starts
  from;
- _kmeans with farthest-point and uniform seeding: means within 1e-6,
  counts equal;
- _layer_update with expiry on the injected replacement rows: embed_avg and
  cluster_size within 1e-6, embed within 1e-5 (after the smoothing);
- rvq_forward(train=True), from a pending codebook (the k-means init) and
  from an inited one, with fewer rows than codes (draws with replacement)
  and more (a permutation): codes bit-identical, quantized, commit loss and
  the new state within 1e-6 (embed 1e-5), the straight-through gradient
  within 1e-6;
- JAX's eval branch is rvq_quantize;
- every nearest-code search of a training forward gets detached inputs
  under no_grad (a spy on vq.nearest), so that on the card it launches the
  VQ kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ttts_tpu.models import quantize as jq
from ttts_tpu_torch.models import quantize as tq
from ttts_tpu_torch.ops.cuda import vq

D, BINS = 16, 32
TOL, EMBED_TOL = 1e-6, 1e-5


def _jax_idx(key, n: int, num: int) -> np.ndarray:
    """JAX's _sample_vectors rows: a permutation's first `num`, or `num`
    draws with replacement when n < num."""
    if n >= num:
        return np.asarray(jax.random.permutation(key, n)[:num])
    return np.asarray(jax.random.randint(key, (num,), 0, n))


def jax_vq_draws(key, n_rows: int, n_q: int, bins: int, seeding: str) -> dict:
    """The draws JAX's rvq_forward takes from `key`, as the port's
    quantize.vq_draws lays them out."""
    n_km = min(n_rows, tq.KMEANS_SAMPLES)
    kmeans, replace = [], []
    for i in range(n_q):
        ki = jax.random.fold_in(key, 1000 + i)
        kmeans.append(torch.tensor(np.asarray(jax.random.randint(ki, (), 0, n_km)))
                      if seeding == "farthest_point" else torch.tensor(_jax_idx(ki, n_km, bins)))
        replace.append(torch.tensor(_jax_idx(jax.random.fold_in(key, i), n_rows, bins)))
    return {"kmeans": kmeans, "replace": replace}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), rtol=tol, atol=tol)


def _state_close(got: tq.RVQState, want: jq.RVQState):
    _close(got.embed, want.embed, EMBED_TOL)
    _close(got.embed_avg, want.embed_avg)
    _close(got.cluster_size, want.cluster_size)
    assert bool(got.inited) == bool(want.inited)


def _port_state(st: jq.RVQState) -> tq.RVQState:
    return tq.RVQState(*(torch.tensor(np.asarray(getattr(st, k)))
                         for k in ("embed", "embed_avg", "cluster_size", "inited")))


def _clustered(rng, n, d=D, centers=6):
    """n rows around a few centres, so that k-means has something to find."""
    c = rng.standard_normal((centers, d)) * 3.0
    return (c[rng.integers(0, centers, n)] + rng.standard_normal((n, d))).astype(np.float32)


def test_rvq_init():
    """rvq_init, and the buffers a training codec's quantizer starts from
    (ResidualVQ(kmeans_pending=True)), are JAX's pending state."""
    from ttts_tpu_torch.models.vqvae import ResidualVQ

    j = jq.rvq_init(jax.random.key(0), 2, BINS, D)
    for t in (tq.rvq_init(2, BINS, D), ResidualVQ(D, 2, BINS, kmeans_pending=True).state()):
        for k in ("embed", "embed_avg", "cluster_size"):
            np.testing.assert_array_equal(getattr(t, k).numpy(), np.asarray(getattr(j, k)))
        assert not bool(t.inited) and not bool(j.inited)


@pytest.mark.parametrize("seeding,n", [("farthest_point", 200), ("farthest_point", 600),
                                       ("uniform", 200), ("uniform", 20)])
def test_kmeans_seedings(seeding, n):
    """600 rows: the 500-sample cap; 20 < 32 codes: uniform seeds drawn with
    replacement, farthest-point seeds repeating."""
    rng = np.random.default_rng(n)
    x = _clustered(rng, n)
    key = jax.random.key(3)
    jm, jc = jq._kmeans(key, jnp.asarray(x), BINS, seeding=seeding)
    n_km = min(n, tq.KMEANS_SAMPLES)
    seed = (torch.tensor(np.asarray(jax.random.randint(key, (), 0, n_km)))
            if seeding == "farthest_point" else torch.tensor(_jax_idx(key, n_km, BINS)))
    tm, tc = tq._kmeans(torch.tensor(x), BINS, seed, seeding=seeding)
    _close(tm, jm)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_layer_update_expiry():
    """A codebook whose low-usage codes expire this step: the replacements
    are JAX's injected rows, embed_avg and cluster_size reset for them."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, D)).astype(np.float32)
    embed = rng.standard_normal((BINS, D)).astype(np.float32)
    size = rng.uniform(0.0, 6.0, BINS).astype(np.float32)  # several below 2 after the decay
    avg = (embed * size[:, None]).astype(np.float32)
    idx = np.argmin(((x[:, None] - embed[None]) ** 2).sum(-1), -1)
    onehot = np.eye(BINS, dtype=np.float32)[idx]
    key = jax.random.key(5)
    want = jq._layer_update((jnp.asarray(embed), jnp.asarray(avg), jnp.asarray(size)),
                            jnp.asarray(x), jnp.asarray(onehot), key, 0.99, 1e-5, 2.0, None)
    got = tq._layer_update(torch.tensor(embed), torch.tensor(avg), torch.tensor(size),
                           torch.tensor(x), torch.tensor(onehot),
                           torch.tensor(_jax_idx(key, 64, BINS)), 0.99, 1e-5, 2.0)
    assert (np.asarray(want[2]) == 1.0).sum() >= 3  # some codes did expire
    _close(got[0], want[0], EMBED_TOL)
    _close(got[1], want[1])
    _close(got[2], want[2])


def _rvq_case(pending: bool, rows: int, seeding: str, n_q: int = 2):
    rng = np.random.default_rng(rows + n_q)
    b = 2
    x = _clustered(rng, b * rows).reshape(b, rows, D)
    if pending:
        st = jq.rvq_init(jax.random.key(0), n_q, BINS, D)
    else:
        embed = rng.standard_normal((n_q, BINS, D)).astype(np.float32)
        size = rng.uniform(0.5, 8.0, (n_q, BINS)).astype(np.float32)
        st = jq.RVQState(embed=jnp.asarray(embed), embed_avg=jnp.asarray(embed * size[..., None]),
                         cluster_size=jnp.asarray(size), inited=jnp.asarray(True))
    w = rng.standard_normal(x.shape).astype(np.float32)
    return x, w, st, jax.random.key(rows)


@pytest.mark.parametrize("pending,rows,seeding", [
    (True, 8, "farthest_point"), (True, 40, "farthest_point"), (True, 40, "uniform"),
    (False, 8, "farthest_point"), (False, 40, "uniform")])
def test_rvq_forward_train(pending, rows, seeding):
    """B * rows = 16 (fewer than 32 codes) or 80 training rows, two layers."""
    x, w, st, key = _rvq_case(pending, rows, seeding)

    def loss(xx):
        q, codes, commit, new = jq.rvq_forward(st, xx, key, train=True,
                                               kmeans_seeding=seeding)
        return jnp.sum(q * w) + commit, (q, codes, commit, new)

    (_, (jqz, jcodes, jcommit, jnew)), jgrad = jax.value_and_grad(loss, has_aux=True)(
        jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    draws = jax_vq_draws(key, x.shape[0] * x.shape[1], 2, BINS, seeding)
    q, codes, commit, new = tq.rvq_forward(_port_state(st), xt, draws=draws,
                                           kmeans_seeding=seeding)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    _close(q, jqz)
    _close(commit, jcommit)
    _state_close(new, jnew)
    (grad,) = torch.autograd.grad(torch.sum(q * torch.tensor(w)) + commit, xt)
    _close(grad, jgrad)


def test_rvq_forward_eval_branch_unchanged():
    """JAX's eval branch (rvq_forward with train=False) is the port's
    rvq_quantize: the same codes and quantized vectors, the state unread."""
    x, _, st, key = _rvq_case(False, 12, "farthest_point")
    jqz, jcodes, jcommit, jnew = jq.rvq_forward(st, jnp.asarray(x), key, train=False)
    q, codes = tq.rvq_quantize(_port_state(st).embed, torch.tensor(x))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    _close(q, jqz)
    assert float(jcommit) == 0.0
    _state_close(_port_state(st), jnew)


def test_vq_draws_follow_the_generator():
    a, b = (tq.vq_draws(80, 2, BINS, "uniform", torch.Generator().manual_seed(4))
            for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a["kmeans"] + a["replace"],
                                                  b["kmeans"] + b["replace"]))
    assert a["replace"][0].unique().numel() == BINS  # 80 >= 32: without replacement
    c = tq.vq_draws(16, 1, BINS, "farthest_point", torch.Generator().manual_seed(4))
    assert c["kmeans"][0].ndim == 0 and c["replace"][0].max() < 16


@pytest.mark.parametrize("pending", [True, False])
def test_training_searches_are_detached(monkeypatch, pending):
    """The spy: no input that vq.nearest receives in a training forward
    requires grad, and grad mode is off there (the init's residual pass and
    each layer's search), so the dispatch's kernel gate holds on the card."""
    seen = []
    real = vq.nearest

    def spy(x, cb):
        seen.append((x.requires_grad, cb.requires_grad, torch.is_grad_enabled()))
        return real(x, cb)

    monkeypatch.setattr(vq, "nearest", spy)
    x, _, st, key = _rvq_case(pending, 40, "farthest_point")
    xt = torch.tensor(x, requires_grad=True)
    draws = jax_vq_draws(key, 80, 2, BINS, "farthest_point")
    q, _, commit, _ = tq.rvq_forward(_port_state(st), xt * 1.0, draws=draws)
    assert len(seen) == (4 if pending else 2)  # init: one per layer, then one per layer
    assert not any(any(s) for s in seen)
    assert q.requires_grad and commit.requires_grad
