"""PyTorch port parity of the codec's training forward (ttts_tpu_torch.
models.vqvae.SynthesizerTrn(for_training=True).forward against ttts_tpu's
SynthesizerTrn.__call__(train=True)) on the CPU, in f32, at TINY widths:

- y_hat, the stats (z, z_p, m_p, logs_p, m_q, logs_q), the quantized content
  and the commit loss within 1e-4 relative (L2), the updated codebook
  within 1e-5, with JAX's draws injected: enc_q's noise recovered from its
  stats, (z - m_q) / exp(logs_q) on the valid frames, the slice starts from
  its output, the quantizer's k-means / expiry rows from the key JAX's
  rvq_forward receives (recorded);
- the gradients of every generator parameter, carried into the port's
  layout by the porting map (for the training model a pure relayout),
  within 1e-4 relative (L2) per tensor, plus 1e-6 of the global norm for
  gradients that are zero analytically (the attention key biases, which the
  softmax cancels, are f32 noise on both sides). One exception, measured:
  the first stage of enc_q's raw-audio path (down_pre, downs.0 and its
  three ResBlocks, at 1/10 of the sample rate and above), where JAX's
  compiled f32 gradients read up to 2.1e-3 off the port's f64 ones while
  the port's f32 gradients are within 2e-6 of them (and the same encoder
  alone matches JAX within 2e-6): there the port's f32 gradient is held to
  its own f64 one at 1e-5 and to JAX's at 3e-3;
- an odd frame count raises before the forward starts;
- dropout acts in train mode only.

Dropout masks cannot match JAX's, so the parity cases run with dropout 0
(VQ_TINY's p_dropout, and MelStyleEncoder's fixed 0.1 set to 0 on both
sides). Weights: jax.eval_shape of the training init filled from a numpy
seed (test_torch_codec_synth._fill), with an inited codebook whose cluster
sizes keep every code alive, or rvq_init's pending one."""

import dataclasses
import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_api import TINY as JTINY
from test_torch_codec_synth import _fill, rel
from test_torch_config import to_port
from test_torch_quantize_train import jax_vq_draws
from ttts_tpu.models import blocks as jblocks
from ttts_tpu.models import quantize as jq
from ttts_tpu.models import vqvae as jvqvae
from ttts_tpu_torch import porting
from ttts_tpu_torch.models import blocks, vqvae
from ttts_tpu_torch.models.quantize import vq_draws

C = JTINY.vqvae
SPEC_CH = JTINY.audio.filter_length // 2 + 1
HOP = JTINY.audio.hop_length
SEG = 4  # frames of a decoded slice (segment_size 2560 / hop 640)
FWD_TOL, GRAD_TOL, GRAD_FLOOR = 1e-4, 1e-4, 1e-6
# enc_q's first audio stage: JAX's compiled f32 gradients there are off its
# f64 value by up to 2.1e-3 (see the module docstring); the port at f64
STAGE0 = ("enc_q.down_pre.", "enc_q.downs.0.", "enc_q.resblocks.0.", "enc_q.resblocks.1.",
          "enc_q.resblocks.2.")
STAGE0_JAX_TOL, STAGE0_F64_TOL = 3e-3, 1e-5


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """One torch thread while a module that imports this runs: the suite
    runs in several worker processes on the machine's cores, and torch's
    OpenMP threads of all of them contending made these convolution-heavy
    tests 4-100x slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def no_style_dropout(monkeypatch):
    """JAX's MelStyleEncoder has a fixed dropout of 0.1: set it to 0."""
    monkeypatch.setattr(jvqvae, "MelStyleEncoder",
                        functools.partial(jblocks.MelStyleEncoder, p_dropout=0.0))


def no_dropout(module: torch.nn.Module) -> torch.nn.Module:
    for m in module.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return module


def gan_inputs(seed=3, frames=8, b=2):
    """wav (B, frames*hop, 1), a random spectrogram pair (the step computes
    its own), spec lengths (the second row padded), text and its lengths."""
    rng = np.random.default_rng(seed)
    wav = (rng.standard_normal((b, frames * HOP, 1)) * 0.1).astype(np.float32)
    spec = np.abs(rng.standard_normal((b, frames, SPEC_CH))).astype(np.float32)
    spec_aug = np.abs(rng.standard_normal((b, frames, SPEC_CH))).astype(np.float32)
    wav_aug = (rng.standard_normal((b, frames * HOP, 1)) * 0.1).astype(np.float32)
    text = rng.integers(0, C.n_text_tokens, (b, 16))
    lengths = np.asarray([frames, frames - 2][:b], np.int32)
    return wav, wav_aug, spec, spec_aug, lengths, text, np.asarray([16, 9][:b], np.int32)


def codebook(rng, alive: bool = True):
    """An inited codebook whose cluster sizes (100) keep every code alive,
    or (alive False) rvq_init's pending state."""
    if not alive:
        return {"quantizer": {"state": jq.rvq_init(jax.random.key(0), C.n_q, C.codebook_bins,
                                                   C.inter_channels)}}
    emb = rng.standard_normal((C.n_q, C.codebook_bins, C.inter_channels)).astype(np.float32)
    size = np.full((C.n_q, C.codebook_bins), 100.0, np.float32)
    return {"quantizer": {"state": jq.RVQState(
        embed=jnp.asarray(emb), embed_avg=jnp.asarray(emb * size[..., None]),
        cluster_size=jnp.asarray(size), inited=jnp.asarray(True))}}


def training_variables(model, seed: int = 0, alive: bool = True):
    """Seeded variables of JAX's training init (enc_q included)."""
    wav, _, spec, _, lengths, text, tl = gan_inputs()
    rngs = {k: jax.random.key(i) for i, k in enumerate(("params", "noise", "slice", "vq"))}
    shapes = jax.eval_shape(lambda: model.init(rngs, wav, wav, spec, spec, lengths, text, tl,
                                               train=True))
    rng = np.random.default_rng(seed)
    flat = flax.traverse_util.flatten_dict(shapes["params"])
    params = flax.traverse_util.unflatten_dict(
        {k: jnp.asarray(_fill(k, v.shape, rng), jnp.float32) for k, v in flat.items()})
    return {"params": params, "codebook": codebook(rng, alive)}


def port_generator(variables, cfg=C) -> vqvae.SynthesizerTrn:
    model = vqvae.SynthesizerTrn(to_port(cfg), spec_channels=SPEC_CH, segment_frames=SEG,
                                 for_training=True)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in porting.synthesizer_trn_state_dict(
        variables, for_training=True).items()})
    return no_dropout(model)


def recovered_noise(stats, y_mask) -> np.ndarray:
    """enc_q's noise from JAX's stats: (z - m_q) / exp(logs_q) on the valid
    frames, 0 elsewhere (where z is masked)."""
    z, _, _, _, m_q, logs_q = (np.asarray(s, np.float64) for s in stats)
    m = np.asarray(y_mask) > 0
    return np.where(m, (z - m_q) / np.exp(logs_q), 0.0).astype(np.float32)


class RvqKeys:
    """Records the key each JAX rvq_forward call receives when it runs (a
    debug callback, so that it works under jit)."""

    def __init__(self, monkeypatch):
        self.keys = []
        real = jvqvae.rvq_forward

        def spy(state, x, key, *a, **k):
            jax.debug.callback(lambda d: self.keys.append(
                jax.random.wrap_key_data(jnp.asarray(d))), jax.random.key_data(key))
            return real(state, x, key, *a, **k)

        monkeypatch.setattr(jvqvae, "rvq_forward", spy)


@pytest.fixture(scope="module")
def forward_case():
    """JAX's training forward and its gradients, once for the module: a
    pending codebook (the k-means init runs) and a scalar of every output."""
    with pytest.MonkeyPatch.context() as mp:
        no_style_dropout(mp)
        keys = RvqKeys(mp)
        model = jvqvae.SynthesizerTrn(C, spec_channels=SPEC_CH, segment_frames=SEG)
        variables = training_variables(model, alive=False)
        inputs = gan_inputs()
        rng = np.random.default_rng(11)
        weights = [rng.standard_normal(s).astype(np.float32) for s in
                   ((2, SEG * HOP, 1),) + ((2, 8, C.inter_channels),) * 7]
        rngs = {"noise": jax.random.key(21), "slice": jax.random.key(22),
                "vq": jax.random.key(23), "dropout": jax.random.key(24)}

        def loss_fn(params):
            (y_hat, commit, ids, y_mask, stats, quantized), mut = model.apply(
                {"params": params, "codebook": variables["codebook"]},
                *(jnp.asarray(a) for a in inputs), train=True, rngs=rngs, mutable=["codebook"])
            outs = (y_hat, *stats, quantized)
            total = commit + sum(jnp.sum(o * w) for o, w in zip(outs, weights))
            return total, (y_hat, commit, ids, y_mask, stats, quantized, mut)

        (_, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
        key = keys.keys[0]
    return model, variables, inputs, weights, jax.tree_util.tree_map(np.asarray, aux), grads, key


def _port_forward(port, inputs, stats, y_mask, ids, key, dtype=torch.float32):
    draws = jax_vq_draws(key, 2 * 4, C.n_q, C.codebook_bins, C.kmeans_seeding)
    cast = lambda a: (torch.tensor(a).to(dtype) if a.dtype.kind == "f"  # noqa: E731
                      else torch.tensor(a))
    return port.to(dtype)(*(cast(a) for a in inputs),
                          noise=cast(recovered_noise(stats, y_mask)),
                          ids_slice=torch.tensor(ids), vq_draws=draws)


def _port_grads(port, out, weights):
    g_y, g_commit, _, _, g_stats, g_q = out
    dt = g_y.dtype
    total = g_commit + sum(torch.sum(o * torch.tensor(w).to(dt))
                           for o, w in zip((g_y, *g_stats, g_q), weights))
    names, params = zip(*port.named_parameters())
    return names, torch.autograd.grad(total, params, allow_unused=True)


def test_training_forward_and_grads(forward_case):
    model, variables, inputs, weights, aux, jgrads, key = forward_case
    y_hat, commit, ids, y_mask, stats, quantized, mut = aux
    port = port_generator(variables).train()
    out = _port_forward(port, inputs, stats, y_mask, ids, key)
    g_y, g_commit, g_ids, g_mask, g_stats, g_q = out
    np.testing.assert_array_equal(g_ids.numpy(), ids)
    np.testing.assert_array_equal(g_mask.numpy(), y_mask)
    assert abs(g_commit.item() - float(commit)) <= FWD_TOL * abs(float(commit))
    for got, want in zip((g_y, *g_stats, g_q), (y_hat, *stats, quantized)):
        assert got.shape == want.shape and rel(got.detach(), want) <= FWD_TOL
    st = mut["codebook"]["quantizer"]["state"]
    buf = port.quantizer.state()
    for k in ("embed", "embed_avg", "cluster_size"):
        np.testing.assert_allclose(getattr(buf, k).numpy(), np.asarray(getattr(st, k)),
                                   rtol=1e-5, atol=1e-5)
    assert bool(buf.inited) and bool(st.inited)
    names, grads = _port_grads(port, out, weights)
    want_sd = porting.synthesizer_trn_state_dict(
        {"params": jgrads, "codebook": variables["codebook"]}, for_training=True)
    assert set(names) <= set(want_sd)
    floor = GRAD_FLOOR * np.sqrt(sum(float(np.sum(np.square(want_sd[n]))) for n in names))
    f64 = port_generator(variables).train()
    _, grads64 = _port_grads(f64, _port_forward(f64, inputs, stats, y_mask, ids, key,
                                                torch.float64), weights)
    stage0 = 0
    for n, g, g64 in zip(names, grads, grads64):
        want = want_sd[n]
        got = np.zeros_like(want) if g is None else g.numpy()
        err = np.linalg.norm(got.astype(np.float64) - want)
        tol = GRAD_TOL
        if n.startswith(STAGE0):
            stage0 += 1
            ref = g64.numpy()
            assert np.linalg.norm(got - ref) <= STAGE0_F64_TOL * np.linalg.norm(ref), n
            tol = STAGE0_JAX_TOL
        assert err <= tol * np.linalg.norm(want) + floor, (n, err, np.linalg.norm(want))
    # down_pre (w, b), downs.0 and 3 ResBlocks x 6 convs (v, g, b)
    assert stage0 == 2 + 3 + 3 * 6 * 3


def test_odd_frame_count_raises():
    port = vqvae.SynthesizerTrn(to_port(C), spec_channels=SPEC_CH, segment_frames=SEG,
                                for_training=True).train()
    wav, wav_aug, spec, spec_aug, lengths, text, tl = gan_inputs(frames=7)
    args = [torch.tensor(a) for a in (wav, wav_aug, spec, spec_aug, lengths, text, tl)]
    with pytest.raises(ValueError, match="even count"):
        port(*args)
    assert not bool(port.quantizer.state().inited)  # it raised before the k-means init
    with pytest.raises(RuntimeError, match="for_training"):
        vqvae.SynthesizerTrn(to_port(C), spec_channels=SPEC_CH)(*args)


def _twice(fn):
    with torch.no_grad():
        return fn(), fn()


@pytest.mark.parametrize("which", ["transformer", "style", "wn", "synthesizer"])
def test_dropout_active_only_in_train_mode(which):
    """Each block with dropout, and the codec's forward as a whole (on the
    same codebook state each call), draws new masks in train mode and none
    in eval mode."""
    torch.manual_seed(0)
    x, mask = torch.randn(2, 12, 16), torch.ones(2, 12, 1)
    if which == "transformer":
        m = blocks.TransformerEncoder(16, 32, 2, 2, 3, p_dropout=0.3)
        fn = lambda: m(x, mask)  # noqa: E731
    elif which == "style":
        m = blocks.MelStyleEncoder(n_mel_channels=16, style_vector_dim=8)
        fn = lambda: m(x, mask)  # noqa: E731
    elif which == "wn":
        m = blocks.WN(16, 5, 1, 2, p_dropout=0.3)
        fn = lambda: m(x, mask)  # noqa: E731
    else:
        m = vqvae.SynthesizerTrn(to_port(dataclasses.replace(C, p_dropout=0.3)),
                                 spec_channels=SPEC_CH, segment_frames=SEG, for_training=True)
        args = [torch.tensor(a) for a in gan_inputs()]
        kw = {"noise": torch.zeros(2, 8, C.inter_channels), "ids_slice": torch.zeros(2).long(),
              "vq_draws": vq_draws(8, C.n_q, C.codebook_bins, C.kmeans_seeding,
                                   torch.Generator().manual_seed(0))}
        state = m.quantizer.state()

        def fn():
            m.quantizer.set_state(state)
            return m(*args, **kw)[0]
    m.eval()
    a, b = _twice(fn)
    m.train()
    c, d = _twice(fn)
    assert torch.equal(a, b) and not torch.equal(c, d) and not torch.equal(a, c)
