"""The port's optimizer chain (ttts_tpu_torch.train.state.AdamW) against
optax itself, as the JAX package builds it (make_adamw, with_accumulation,
apply_gradients_safe), on identical injected gradients: the global-norm
clip (scaled steps and unscaled ones), the warmup, weight decay,
MultiSteps accumulation with k=1 and k=3, a non-finite micro-step, and the
EMA. Parameters after every one of 5 steps within 1e-6 (f32, the same
arithmetic in another order at most)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from ttts_tpu.train import state as jstate
from ttts_tpu.train.steps import apply_gradients_safe as japply
from ttts_tpu_torch.train import state as tstate
from ttts_tpu_torch.train.steps import apply_gradients_safe as tapply

TOL = 1e-6
SHAPES = {"a": (3, 4), "b": (5,), "c": (2, 3, 2)}


class Params(nn.Module):
    def __init__(self, arrays):
        super().__init__()
        for k, v in arrays.items():
            setattr(self, k, nn.Parameter(torch.tensor(v)))


def _grads(rng, step, nonfinite=None):
    """Seeded gradients; step 1 large (clipped), the others small; NaN in
    one leaf on the step named `nonfinite`."""
    scale = 3.0 if step == 1 else 0.05
    g = {k: (scale * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}
    if step == nonfinite:
        g["b"][2] = np.nan
    return g


def _run(accumulate: int, nonfinite=None, steps: int = 5, **opt):
    rng = np.random.default_rng(3)
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    tx = jstate.with_accumulation(jstate.make_adamw(**opt), accumulate)
    jst = jstate.TrainState.create(apply_fn=None, params={k: jnp.asarray(v) for k, v in
                                                          init.items()}, tx=tx)
    # the step as an array, as it is inside the jitted train step (a Python
    # int has no dtype and would pass apply_gradients_safe's merge unmerged)
    jst = jst.replace(step=jnp.asarray(0))
    model = Params(init)
    names = [n for n, _ in model.named_parameters()]
    tst = tstate.TrainState.create(model, lambda ps: tstate.with_accumulation(
        tstate.make_adamw(ps, **opt), accumulate))
    out = []
    for step in range(steps):
        g = _grads(rng, step, nonfinite)
        jst, jnorm, jfin = japply(jst, {k: jnp.asarray(v) for k, v in g.items()})
        tnorm, tfin, _ = tapply(tst, [torch.tensor(g[n]) for n in names])
        assert bool(jfin) == tfin
        if tfin:
            np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
        assert int(jst.step) == tst.step
        for n, p in zip(names, tst.params):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jst.params[n]),
                                       atol=TOL, rtol=0, err_msg=f"step {step} {n}")
        out.append({n: p.detach().numpy().copy() for n, p in zip(names, tst.params)})
    return out


OPT = dict(lr=1e-2, warmup_steps=3, betas=(0.9, 0.96), weight_decay=0.01, grad_clip=1.0)


@pytest.mark.parametrize("accumulate", [1, 3])
def test_adamw_chain_matches_optax(accumulate):
    """Clip (step 1's norm is above 1), warmup over 3 updates and weight
    decay, with and without MultiSteps."""
    hist = _run(accumulate, **OPT)
    if accumulate == 3:  # between updates the parameters stay put
        np.testing.assert_array_equal(hist[0]["a"], hist[1]["a"])
        assert not np.array_equal(hist[1]["a"], hist[2]["a"])


@pytest.mark.parametrize("accumulate", [1, 3])
def test_nonfinite_micro_step_is_skipped_like_optax(accumulate):
    """A NaN gradient on micro-step 1 leaves parameters, moments,
    accumulator and step counter as they were, in both packages."""
    _run(accumulate, nonfinite=1, **OPT)


@pytest.mark.parametrize("scale", [0.1, 3.0])
def test_clip_formula_is_optax_not_torch(scale):
    """The clip against optax.clip_by_global_norm, unscaled below the limit
    and scaled by max / norm above it, where torch.nn.utils.clip_grad_norm_
    scales by max / (norm + 1e-6) instead."""
    import optax

    rng = np.random.default_rng(1)
    g = {k: (scale * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}
    want, _ = optax.clip_by_global_norm(1.0).update({k: jnp.asarray(v) for k, v in g.items()},
                                                    None)
    got = tstate.clip_by_global_norm([torch.tensor(g[k]) for k in SHAPES], 1.0)
    for k, t in zip(SHAPES, got):
        np.testing.assert_allclose(t.numpy(), np.asarray(want[k]), atol=1e-7, rtol=1e-6)
    ts = [torch.tensor(g[k]) for k in SHAPES]
    torch.nn.utils.clip_grad_norm_(ts, 1.0)  # torch's formula, on tensors as grads
    differs = any(not np.array_equal(a.numpy(), b.numpy()) for a, b in zip(ts, got))
    assert differs == (scale > 1.0)


def test_warmup_schedule_matches():
    for count in range(6):
        assert tstate.warmup_constant_schedule(1e-3, 4)(count) == pytest.approx(
            float(jstate.warmup_constant_schedule(1e-3, 4)(jnp.asarray(count))), rel=1e-7)


def test_ema_update_matches():
    rng = np.random.default_rng(0)
    e, p = (rng.standard_normal((3, 5)).astype(np.float32) for _ in range(2))
    want = jstate.ema_update({"x": jnp.asarray(e)}, {"x": jnp.asarray(p)})["x"]
    got = [torch.tensor(e)]
    tstate.ema_update(got, [torch.tensor(p)])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=TOL, rtol=0)
