"""PyTorch port parity of RVQ1 (ttts_tpu_torch.models.rvq1 against
ttts_tpu.models.rvq1) on the CPU, in f32, at tests/test_rvq1.py's sizes,
each of its four methods at an even (16) and an odd (15) frame count:

- extract_code: codes bit-identical;
- infer and decode: waveforms within WAVE_TOL relative (L2), with the same numpy
  z_p noise injected into both (jax.random.normal patched);
- the training forward from a pending codebook (k-means init, then the
  search and the EMA / expiry update), at 40 and 39 frames (40 rows for
  32 codes): every output and loss within TOL, codes and
  slice starts equal, the codebook state after the step within STATE_TOL, with
  JAX's draws injected (spec_enc's noise as above, the slice starts read
  from its output, the k-means / expiry rows from the key its rvq_forward
  receives); at the odd count JAX's mismatched shapes (T + 1 content
  frames against T posterior frames) come out of both;
- one backward: the gradient of every parameter against jax.grad of the
  same scalar, cosine >= GRAD_COS per tensor (tensors whose JAX gradient is
  below 1e-6 of the global norm, zero analytically, stay below it in the
  port too);
- the weight converters: porting.rvq1_variables inverts rvq1_state_dict,
  and JAX's port_rvq1_state takes the port's state dict back to the JAX
  variables (dec's transposed convolutions through their effective
  weights, as the codec's).

Weights: jax.eval_shape of JAX's training init filled from a numpy seed
(test_torch_codec_synth._fill), with a seeded inited codebook.
Limits, each from the largest of three readings (weight seeds 0-2, the
odd and the even count): waveforms 8.2e-6, so WAVE_TOL 5e-5; training
outputs and losses 2.5e-6, so TOL 1e-5; the codebook state 9.5e-6
absolute, so STATE_TOL 3e-5 (absolute and relative)."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_codec_synth import _reference_ups, rel, seeded_variables
from test_torch_quantize_train import jax_vq_draws
from test_torch_vqvae_train import RvqKeys, torch_threads  # noqa: F401 (autouse)
from ttts_tpu.models import porting as jporting
from ttts_tpu.models.quantize import RVQState
from ttts_tpu.models.rvq1 import RVQ1 as JRVQ1
from ttts_tpu_torch import porting
from ttts_tpu_torch.models.quantize import rvq_init
from ttts_tpu_torch.models.rvq1 import RVQ1

# tests/test_rvq1.py:13-17
KW = dict(spec_channels=65, hubert_channels=64, inter_channels=16, dim=16,
          upsample_initial_channel=32, gin_channels=32, segment_frames=4, codebook_bins=32)
HOP = 640
WAVE_TOL, TOL, STATE_TOL, GRAD_COS, GRAD_FLOOR = 5e-5, 1e-5, 3e-5, 0.9999, 1e-6
FRAMES = [16, 15]
# the training forward's: B ceil(T/2) = 40 rows against 32 codes, so that
# the k-means init leaves a commitment loss
TRAIN_FRAMES = [40, 39]


def _inputs(t, seed=0):
    rng = np.random.default_rng(seed)
    spec = np.abs(rng.standard_normal((2, t, KW["spec_channels"]))).astype(np.float32)
    hubert = rng.standard_normal((2, t, KW["hubert_channels"])).astype(np.float32)
    return spec, hubert


def _codebook(rng, inited=True):
    shape = (1, KW["codebook_bins"], KW["hubert_channels"])
    if not inited:
        z = jnp.zeros(shape)
        return RVQState(embed=z, embed_avg=z, cluster_size=jnp.zeros(shape[:2]),
                        inited=jnp.asarray(False))
    emb = jnp.asarray(rng.standard_normal(shape), jnp.float32)
    return RVQState(embed=emb, embed_avg=emb, cluster_size=jnp.ones(shape[:2]),
                    inited=jnp.asarray(True))


@pytest.fixture(scope="module")
def rvq1():
    """JAX's RVQ1, seeded variables with an inited codebook, and the port
    with the same weights."""
    model = JRVQ1(**KW)
    spec, hubert = _inputs(16)
    rngs = {k: jax.random.key(i) for i, k in enumerate(("params", "noise", "slice", "vq"))}
    params = seeded_variables(lambda: model.init(rngs, spec, hubert, train=True)["params"])
    variables = {"params": params,
                 "codebook": {"quantizer": {"state": _codebook(np.random.default_rng(5))}}}
    return model, variables, load(variables)


def load(variables) -> RVQ1:
    port = RVQ1(**KW)
    port.load_state_dict({k: torch.from_numpy(v)
                          for k, v in porting.rvq1_state_dict(variables).items()})
    return port.eval()


def fixed_normal(monkeypatch, noise: np.ndarray) -> None:
    """jax.random.normal returns `noise` (its one draw in these calls)."""
    def normal(key, shape, *args, **kwargs):
        assert tuple(shape) == noise.shape, (shape, noise.shape)
        return jnp.asarray(noise)

    monkeypatch.setattr(jax.random, "normal", normal)


def _noise(shape, seed=9):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in flax.traverse_util.flatten_dict(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def test_converter_round_trip(rvq1):
    _, variables, port = rvq1
    sd = porting.rvq1_state_dict(variables)
    assert set(sd) == set(port.state_dict())
    want = _flat(variables["params"])
    back = porting.rvq1_variables({k: torch.from_numpy(v) for k, v in sd.items()})
    got = _flat(back["params"])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    st = variables["codebook"]["quantizer"]["state"]
    for k in ("embed", "embed_avg", "cluster_size"):
        np.testing.assert_array_equal(back["codebook"]["quantizer"]["state"][k],
                                      np.asarray(getattr(st, k)))
    # JAX's own porter of the reference's state dict takes it back too
    ref = jporting.port_rvq1_state(_reference_ups(sd))
    got = _flat(ref["params"])
    assert set(got) == set(want)
    for k in want:
        if "ConvTranspose1d" in k and not k.endswith("bias"):
            continue
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for i in range(5):
        eff = []
        for tree in (variables["params"]["dec"], ref["params"]["dec"]):
            ct = tree[f"ConvTranspose1d_{i}"]
            kern = np.asarray(ct["kernel"], np.float64)
            norm = np.sqrt((kern.reshape(-1, kern.shape[-1]) ** 2).sum(0))
            eff.append(kern * np.asarray(ct["g"]) / norm)
        np.testing.assert_allclose(eff[1], eff[0], rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(ref["codebook"]["quantizer"]["state"].embed, st.embed)


@pytest.mark.parametrize("t", FRAMES)
def test_extract_code(rvq1, t):
    model, variables, port = rvq1
    spec, _ = _inputs(t)
    want = np.asarray(jax.jit(lambda v, s: model.apply(v, s, method=model.extract_code))(
        variables, spec))
    with torch.no_grad():
        got = port.extract_code(torch.from_numpy(spec)).numpy()
    assert want.shape == got.shape == (2, 1, -(-t // 2))
    assert len(np.unique(want)) > 1
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("t", FRAMES)
def test_infer(rvq1, t, monkeypatch):
    model, variables, port = rvq1
    spec, _ = _inputs(t)
    frames = 2 * -(-t // 2)  # the content path's 2 ceil(T/2)
    noise = _noise((2, frames, KW["inter_channels"]))
    fixed_normal(monkeypatch, noise)
    want = np.asarray(jax.jit(lambda v, s: model.apply(
        v, s, 0.7, method=model.infer, rngs={"noise": jax.random.key(1)}))(variables, spec))
    with torch.no_grad():
        got = port.infer(torch.from_numpy(spec), 0.7, noise=torch.from_numpy(noise))
    assert got.shape == want.shape == (2, frames * HOP, 1)
    assert np.isfinite(got.numpy()).all() and rel(got, want) <= WAVE_TOL


@pytest.mark.parametrize("t", FRAMES)
def test_decode(rvq1, t, monkeypatch):
    model, variables, port = rvq1
    spec, _ = _inputs(t, seed=1)
    codes = np.random.default_rng(t).integers(0, KW["codebook_bins"], (1, 2, 6))
    noise = _noise((2, 12, KW["inter_channels"]))
    fixed_normal(monkeypatch, noise)
    want = np.asarray(jax.jit(lambda v, c, s: model.apply(
        v, c, s, 0.5, method=model.decode, rngs={"noise": jax.random.key(2)}))(
            variables, codes, spec))
    with torch.no_grad():
        got = port.decode(torch.from_numpy(codes), torch.from_numpy(spec), 0.5,
                          noise=torch.from_numpy(noise))
    assert got.shape == want.shape == (2, 12 * HOP, 1)
    assert rel(got, want) <= WAVE_TOL


def test_infer_draws_from_the_generator(rvq1):
    _, _, port = rvq1
    spec = torch.from_numpy(_inputs(16)[0])
    with torch.no_grad():
        a, b, c = (port.infer(spec, generator=torch.Generator().manual_seed(s)) for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)


def _weights(shapes, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _outputs(out):
    o, commit, ids, stats, quantized, sem = out
    return (o, *stats, quantized), commit, sem, ids


def _jax_training(model, variables, spec, hubert, noise, monkeypatch, weights=None):
    """JAX's training forward from a pending codebook (and, with `weights`,
    the gradient of commit + semantic loss + sum(out * w)): its outputs, the
    updated codebook, the rvq key, the gradients."""
    fixed_normal(monkeypatch, noise)
    keys = RvqKeys(monkeypatch)
    codebook = {"quantizer": {"state": _codebook(None, inited=False)}}
    rngs = {"noise": jax.random.key(21), "slice": jax.random.key(22), "vq": jax.random.key(23)}

    def run(params):
        out, mut = model.apply({"params": params, "codebook": codebook}, spec, hubert,
                               train=True, rngs=rngs, mutable=["codebook"])
        outs, commit, sem, _ = _outputs(out)
        total = commit + sem
        if weights is not None:
            total = total + sum(jnp.sum(o * w) for o, w in zip(outs, weights))
        return total, (out, mut)

    if weights is None:
        _, (out, mut) = jax.jit(run)(variables["params"])
        grads = None
    else:
        (_, (out, mut)), grads = jax.jit(jax.value_and_grad(run, has_aux=True))(
            variables["params"])
    return out, mut["codebook"]["quantizer"]["state"], keys.keys[0], grads


def _port_training(variables, spec, hubert, noise, ids, key):
    port = load(variables).train()
    port.quantizer.set_state(rvq_init(1, KW["codebook_bins"], KW["hubert_channels"]))
    draws = jax_vq_draws(key, 2 * -(-spec.shape[1] // 2), 1, KW["codebook_bins"],
                         "farthest_point")
    out = port(torch.from_numpy(spec), torch.from_numpy(hubert), noise=torch.from_numpy(noise),
               ids_slice=torch.tensor(np.asarray(ids)), vq_draws=draws)
    return port, out


def _hold_training_forward(out, st, port, pout, t):
    """The port's training forward (pout, its codebook) against JAX's (out,
    the codebook state st) at t frames."""
    want, commit, sem, ids = _outputs(out)
    got, pcommit, psem, pids = _outputs(pout)
    np.testing.assert_array_equal(pids.numpy(), np.asarray(ids))
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(np.shape(w)) and rel(g.detach(), w) <= TOL
    # JAX's shapes: 2 ceil(T/2) content frames against T posterior frames
    assert got[3].shape[1] == 2 * -(-t // 2) and got[1].shape[1] == t
    for a, b in ((pcommit, commit), (psem, sem)):
        assert float(b) > 0 and abs(a.item() - float(b)) <= TOL * float(b)
    buf = port.quantizer.state()
    for k in ("embed", "embed_avg", "cluster_size"):
        np.testing.assert_allclose(getattr(buf, k).numpy(), np.asarray(getattr(st, k)),
                                   rtol=STATE_TOL, atol=STATE_TOL)
    assert bool(buf.inited) and bool(st.inited)


def test_training_forward(rvq1, monkeypatch):
    """At the odd count (the even one: test_training_gradients)."""
    model, variables, _ = rvq1
    t = TRAIN_FRAMES[1]
    spec, hubert = _inputs(t, seed=2)
    noise = _noise((2, t, KW["inter_channels"]), seed=t)
    out, st, key, _ = _jax_training(model, variables, spec, hubert, noise, monkeypatch)
    port, pout = _port_training(variables, spec, hubert, noise, out[2], key)
    _hold_training_forward(out, st, port, pout, t)


def test_training_gradients(rvq1, monkeypatch):
    """At the even count: the forward as test_training_forward holds it,
    then the gradients."""
    model, variables, _ = rvq1
    t = TRAIN_FRAMES[0]
    spec, hubert = _inputs(t, seed=3)
    noise = _noise((2, t, KW["inter_channels"]), seed=4)
    shapes = [(2, KW["segment_frames"] * HOP, 1)] + [(2, t, KW["inter_channels"])] * 6 + [
        (2, t, KW["hubert_channels"])]
    weights = _weights(shapes)
    out, st, key, jgrads = _jax_training(model, variables, spec, hubert, noise, monkeypatch,
                                         weights)
    port, pout = _port_training(variables, spec, hubert, noise, out[2], key)
    _hold_training_forward(out, st, port, pout, t)
    outs, commit, sem, _ = _outputs(pout)
    total = commit + sem + sum(torch.sum(o * torch.from_numpy(w)) for o, w in zip(outs, weights))
    names, params = zip(*port.named_parameters())
    grads = torch.autograd.grad(total, params, allow_unused=True)
    want_sd = porting.rvq1_state_dict({"params": jgrads, "codebook": variables["codebook"]})
    assert set(names) <= set(want_sd)
    floor = GRAD_FLOOR * np.sqrt(sum(float(np.sum(np.square(want_sd[n]))) for n in names))
    checked = 0
    for n, g in zip(names, grads):
        want = want_sd[n].astype(np.float64).ravel()
        got = np.zeros_like(want) if g is None else g.numpy().astype(np.float64).ravel()
        if np.linalg.norm(want) <= floor:
            assert np.linalg.norm(got) <= 10 * floor, n
            continue
        cos = float(got @ want / (np.linalg.norm(got) * np.linalg.norm(want)))
        assert cos >= GRAD_COS, (n, cos)
        checked += 1
    assert checked > 0.9 * len(names)
