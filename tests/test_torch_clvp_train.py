"""CLVP and classifier training, the port against the JAX package on the
CPU, in f32, at TINY widths:

- the CLVP training loss (symmetric InfoNCE) and its gradients against
  jax.value_and_grad of JAX's, in both flavours, with text and voice mask
  percentages above 0 and the same mask draws injected into both (JAX's
  jax.random.uniform returns them, so its step can be jitted; dropout off
  on both sides: its masks cannot match): loss within 1e-5, gradients
  within 1e-4 relative (L2) per tensor plus 1e-6 absolute;
- a row whose tokens are all masked: each encoder's output equal to JAX's
  (uniform attention over the filled scores), finite under the port's bf16
  autocast too; the row's similarity NaN (0/0 latent) on both sides and
  the others equal;
- one clvp_train_step against JAX's (the loss and the global grad norm
  within 1e-5, the parameters afterwards within 1e-5 where JAX's gradient
  is above 1e-6, within one learning-rate step elsewhere: there Adam moves
  by the sign of f32 noise), and a batch whose every token is
  masked skipped as non-finite on both sides;
- the classifier's loss (with and without distribute_zero_label), its
  gradients and one classifier_train_step; its dropout active only in
  training mode;
- CLVPDataset's and PreprocessedMelDataset's batches equal to JAX's from
  the same manifest and numpy seed (the crops drawn in __getitem__ order);
- porting.VARIABLES_FNS for both models: forward ∘ inverse is the identity,
  and export_model's `.npz`, read by JAX's load_model and by the port's
  (TextToSpeech.from_checkpoints for the CLVP), gives the same
  similarities (1e-5) and logits (1e-5)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_api import TINY as JTINY
from test_torch_codec_synth import rel, seeded_variables
from test_torch_config import to_port
from test_torch_train_steps import GRAD_FLOOR, _grads_close, _port, _torch
from ttts_tpu.config import ClassifierConfig
from ttts_tpu.data import datasets as jdatasets
from ttts_tpu.infer_utils import load_model as jload_model
from ttts_tpu.models import classifier as jclassifier
from ttts_tpu.models import clvp as jclvp
from ttts_tpu.train import mains as jmains
from ttts_tpu.train import state as jstate
from ttts_tpu.train import steps as jsteps
from ttts_tpu_torch import porting
from ttts_tpu_torch.data import datasets
from ttts_tpu_torch.data.manifest import save_sidecar, write_manifest
from ttts_tpu_torch.infer_utils import load_model
from ttts_tpu_torch.models.classifier import AudioMiniEncoderWithClassifierHead
from ttts_tpu_torch.models.clvp import CLVP
from ttts_tpu_torch.train import mains
from ttts_tpu_torch.train import state as tstate
from ttts_tpu_torch.train import steps as tsteps
from ttts_tpu_torch.train.checkpoints import export_model

CLVP_C = dataclasses.replace(JTINY.clvp, text_mask_percentage=0.2, voice_mask_percentage=0.3)
FLAVOURS = {"xformers": CLVP_C, "plain": dataclasses.replace(CLVP_C, use_xformers=False)}
CLS_C = ClassifierConfig(embedding_dim=64, depth=2, base_channels=16, attn_blocks=1,
                         num_attn_heads=2, kernel_size=3)
TOL = 1e-5


@pytest.fixture(autouse=True)
def no_jax_dropout(monkeypatch):
    """JAX's x-transformers EncoderLayer has a fixed dropout of 0.1: set it
    to 0 (the port's is set to 0 by `no_dropout`)."""
    monkeypatch.setattr(jclvp, "EncoderLayer", functools.partial(jclvp.EncoderLayer,
                                                                 dropout=0.0))


def no_dropout(model: torch.nn.Module) -> torch.nn.Module:
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
        if hasattr(m, "dropout") and isinstance(m.dropout, float):
            m.dropout = 0.0
    return model


def _clvp_batch(seed=0, b=3, lt=10, ls=24):
    rng = np.random.default_rng(seed)
    return {"text": rng.integers(1, 200, (b, lt)).astype(np.int32),
            "speech_tokens": rng.integers(0, 1024, (b, ls)).astype(np.int32)}


@functools.lru_cache(maxsize=None)
def _clvp_variables(flavour: str):
    cfg = FLAVOURS[flavour]
    b = _clvp_batch()
    return seeded_variables(lambda: jclvp.CLVP(cfg).init(
        jax.random.key(0), jnp.asarray(b["text"]), jnp.asarray(b["speech_tokens"])), seed=1)


def _clvp_pair(flavour: str):
    cfg = FLAVOURS[flavour]
    variables = _clvp_variables(flavour)
    port = _port(CLVP(to_port(cfg)), porting.clvp_state_dict(variables))
    return jclvp.CLVP(cfg), variables, no_dropout(port)


def inject_draws(monkeypatch, b, seed=0):
    """Uniform mask draws for the text and the speech codes, returned by
    JAX's jax.random.uniform (picked by shape) and handed to the port."""
    rng = np.random.default_rng(seed)
    draws = {"text": rng.random(b["text"].shape, np.float32),
             "voice": rng.random(b["speech_tokens"].shape, np.float32)}
    by_shape = {v.shape: v for v in draws.values()}
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape=(), *a, **k: jnp.asarray(by_shape[tuple(shape)]))
    return {k: torch.from_numpy(v) for k, v in draws.items()}


def _params_close(port, after, grads, lr):
    """The port's parameters after a step against JAX's (`after`, in the
    port's layout): within TOL where JAX's gradient is above GRAD_FLOOR,
    within one learning-rate step where it is f32 noise."""
    for k, v in port.state_dict().items():
        got, want = v.numpy(), np.asarray(after[k]).reshape(v.shape)
        noise = np.abs(np.asarray(grads[k]).reshape(v.shape)) <= GRAD_FLOOR
        err = np.abs(got - want)
        assert err[~noise].max(initial=0) <= TOL and err[noise].max(initial=0) <= 2 * lr, k


@pytest.mark.parametrize("flavour", list(FLAVOURS))
def test_clvp_loss_and_grads_with_injected_mask_draws(flavour, monkeypatch):
    model, variables, port = _clvp_pair(flavour)
    b = _clvp_batch(seed=2)
    draws = inject_draws(monkeypatch, b)
    assert 0 < float((draws["voice"] <= CLVP_C.voice_mask_percentage).float().mean()) < 1
    def loss_fn(p):
        return model.apply(p, jnp.asarray(b["text"]), jnp.asarray(b["speech_tokens"]),
                           return_loss=True, train=True,
                           rngs={"mask": jax.random.key(3), "dropout": jax.random.key(4)})

    want, grads = jax.jit(jax.value_and_grad(loss_fn))(variables)
    port.train()
    got = port(*_torch(b).values(), return_loss=True, mask_draws=draws)
    assert abs(got.item() - float(want)) <= TOL * abs(float(want))
    names = [n for n, _ in port.named_parameters()]
    _grads_close(names, torch.autograd.grad(got, list(port.parameters()), allow_unused=True),
                 porting.clvp_state_dict(grads))


@pytest.mark.parametrize("flavour", list(FLAVOURS))
def test_all_masked_row(flavour):
    model, variables, port = _clvp_pair(flavour)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 10, CLVP_C.dim_text)).astype(np.float32)
    mask = np.ones((3, 10), bool)
    mask[1] = False
    mask[2, 6:] = False
    if flavour == "xformers":
        enc = jclvp.CLVPEncoder(CLVP_C.dim_text, CLVP_C.text_enc_depth, CLVP_C.text_heads,
                                CLVP_C.dim_head)
        sub = variables["params"]["CLVPEncoder_0"]
    else:
        enc = jclvp.PlainEncoder(CLVP_C.dim_text, CLVP_C.text_enc_depth, CLVP_C.text_heads,
                                 CLVP_C.dim_head)
        sub = variables["params"]["PlainEncoder_0"]
    want = np.asarray(enc.apply({"params": sub}, jnp.asarray(x), jnp.asarray(mask)))
    port.eval()
    with torch.no_grad():
        got = port.text_transformer(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
        with torch.autocast("cpu", dtype=torch.bfloat16):
            half = port.text_transformer(torch.from_numpy(x), torch.from_numpy(mask)).float()
    assert np.isfinite(want).all() and rel(got, want) <= TOL
    assert torch.isfinite(half).all() and rel(half.numpy(), want) <= 5e-2
    b = _clvp_batch(seed=5)
    tmask = np.ones(b["text"].shape, bool)
    tmask[1] = False
    want_sim = np.asarray(model.apply(variables, jnp.asarray(b["text"]),
                                      jnp.asarray(b["speech_tokens"]), jnp.asarray(tmask)))
    with torch.no_grad():
        got_sim = port(*_torch(b).values(), torch.from_numpy(tmask)).numpy()
    assert np.isnan(want_sim[1]) and np.isnan(got_sim[1])
    np.testing.assert_allclose(got_sim[[0, 2]], want_sim[[0, 2]], rtol=TOL, atol=TOL)


def _jax_state(variables, tx):
    return jstate.TrainState.create(apply_fn=None, params=variables, tx=tx)


@pytest.mark.parametrize("skip", [False, True], ids=["finite", "all_masked"])
def test_clvp_train_step_matches_jax(skip, monkeypatch):
    cfg = dataclasses.replace(CLVP_C, text_mask_percentage=1.0) if skip else CLVP_C
    variables = _clvp_variables("xformers")
    port = no_dropout(_port(CLVP(to_port(cfg)), porting.clvp_state_dict(variables)))
    b = _clvp_batch(seed=6)
    draws = inject_draws(monkeypatch, b, seed=1)
    model = jclvp.CLVP(cfg)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jst, want = jax.jit(functools.partial(jsteps.clvp_train_step, model=model))(
        _jax_state(variables, jstate.make_adamw(1e-3, 1)), jb, jax.random.key(7))
    tst = tstate.TrainState.create(port, lambda ps: tstate.make_adamw(ps, 1e-3, 1))
    before = {k: v.clone() for k, v in port.state_dict().items()}
    got = tsteps.clvp_train_step(tst, _torch(b), 0, draws=draws)
    assert got["nonfinite_skipped"] == float(want["nonfinite_skipped"]) == float(skip)
    if skip:
        assert tst.step == 0 and np.isnan(float(got["loss"])) and np.isnan(float(want["loss"]))
        assert all(torch.equal(before[k], v) for k, v in port.state_dict().items())
        return
    assert tst.step == 1
    for k in ("loss", "grad_norm"):
        assert abs(float(got[k]) - float(want[k])) <= TOL * abs(float(want[k])), k
    grads = jax.grad(lambda p: model.apply(p, jb["text"], jb["speech_tokens"], return_loss=True,
                                           train=True, rngs={"mask": jax.random.key(0)}))
    _params_close(port, porting.clvp_state_dict(jst.params),
                  porting.clvp_state_dict(jax.jit(grads)(variables)), 1e-3)


def test_clvp_draws_follow_the_key():
    a, b, c = (tsteps.clvp_draws(k, CLVP_C, (2, 5), (2, 9), torch.device("cpu"))
               for k in (3, 3, 4))
    assert a.keys() == {"text", "voice"} and a["voice"].shape == (2, 9)
    assert torch.equal(a["text"], b["text"]) and not torch.equal(a["text"], c["text"])
    assert tsteps.clvp_draws(3, JTINY.clvp, (2, 5), (2, 9), torch.device("cpu")) == {}


def test_clvp_training_mode_takes_the_masked_path_and_serving_the_kernel(monkeypatch):
    """Without masks (mask percentages 0, as the default configuration
    trains), a training forward attends through the masked plain version
    (its dropout, as JAX's train mode with all-ones masks); an eval call
    through attention.attend, the no-bias kernel's dispatch."""
    from ttts_tpu_torch.ops.cuda import attention

    torch.manual_seed(0)
    port = CLVP(to_port(JTINY.clvp))
    calls = []
    monkeypatch.setattr(attention, "attend", lambda *a, **k: calls.append(1) or
                        attention.flash_attention_plain(*a, **k))
    b = _torch(_clvp_batch())
    n = JTINY.clvp.text_enc_depth + JTINY.clvp.speech_enc_depth
    with torch.no_grad():
        port.eval()(*b.values())
        assert len(calls) == n
        port.train()
        a, c = (port(*b.values(), return_loss=True) for _ in range(2))
    assert len(calls) == n and not torch.equal(a, c)  # dropout drew twice


# --------------------------------------------------------------- classifier


def _mel_batch(seed=0, b=4, t=40):
    rng = np.random.default_rng(seed)
    return {"mel": rng.standard_normal((b, t, 100)).astype(np.float32),
            "labels": np.asarray([0, 1, 0, 1][:b], np.int32)}


@functools.lru_cache(maxsize=None)
def _cls_variables():
    return seeded_variables(lambda: jclassifier.AudioMiniEncoderWithClassifierHead(CLS_C).init(
        jax.random.key(0), jnp.zeros((1, 40, 100))), seed=2)


def _cls_grads(cfg, variables, b):
    model = jclassifier.AudioMiniEncoderWithClassifierHead(cfg)
    return jax.jit(jax.value_and_grad(lambda p: model.apply(
        p, jnp.asarray(b["mel"]), labels=jnp.asarray(b["labels"]))))(variables)


@pytest.mark.parametrize("zero_label", [False, True])
def test_classifier_loss_and_grads(zero_label):
    cfg = dataclasses.replace(CLS_C, distribute_zero_label=zero_label)
    variables = _cls_variables()
    b = _mel_batch()
    want, grads = _cls_grads(cfg, variables, b)
    port = _port(AudioMiniEncoderWithClassifierHead(to_port(cfg)),
                 porting.classifier_state_dict(variables)).train()
    got = port(*_torch(b).values())
    assert abs(got.item() - float(want)) <= TOL * abs(float(want))
    names = [n for n, _ in port.named_parameters()]
    _grads_close(names, torch.autograd.grad(got, list(port.parameters()), allow_unused=True),
                 porting.classifier_state_dict(grads), skip_zero=True)


def test_classifier_train_step_matches_jax():
    variables = _cls_variables()
    b = _mel_batch(seed=3)
    tx = jstate.make_adamw(3e-4, warmup_steps=0, betas=(0.9, 0.9999), weight_decay=0.01,
                           grad_clip=1.0)
    model = jclassifier.AudioMiniEncoderWithClassifierHead(CLS_C)
    jst, want = jax.jit(functools.partial(jsteps.classifier_train_step, model=model))(
        _jax_state(variables, tx), {k: jnp.asarray(v) for k, v in b.items()},
        jax.random.key(1))
    port = _port(AudioMiniEncoderWithClassifierHead(to_port(CLS_C)),
                 porting.classifier_state_dict(variables))
    tst = tstate.TrainState.create(port, lambda ps: tstate.make_adamw(
        ps, 3e-4, warmup_steps=0, betas=(0.9, 0.9999), weight_decay=0.01, grad_clip=1.0))
    got = tsteps.classifier_train_step(tst, _torch(b), 0)
    assert abs(float(got["loss"]) - float(want["loss"])) <= TOL * abs(float(want["loss"]))
    _params_close(port, porting.classifier_state_dict(jst.params),
                  porting.classifier_state_dict(_cls_grads(CLS_C, variables, b)[1]), 3e-4)
    assert tst.step == 1


def test_classifier_dropout_active_only_in_train_mode():
    port = AudioMiniEncoderWithClassifierHead(to_port(dataclasses.replace(CLS_C, dropout=0.5)))
    x = torch.from_numpy(_mel_batch()["mel"])
    with torch.no_grad():
        a, b = port.eval()(x), port(x)
        c, d = port.train()(x), port(x)
    assert torch.equal(a, b) and not torch.equal(c, d)


# ----------------------------------------------------------------- datasets


@pytest.fixture(scope="module")
def sidecars(tmp_path_factory):
    d = tmp_path_factory.mktemp("clvp_data")
    rng = np.random.default_rng(0)
    texts = ["ni3 hao3 shi4 jie4", "jin1 tian1 tian1 qi4 hen3 hao3", "wo3 men5 qu4"]
    rows = []
    (d / "noise").mkdir()
    for i in range(14):
        path = str((d / "noise" if i >= 10 else d) / f"u{i:02d}.wav")
        if i != 4:  # one row without sidecars
            save_sidecar(path, "vq", rng.integers(0, 1024, int(rng.integers(30, 300))))
            save_sidecar(path, "mel", rng.standard_normal(
                (100, int(rng.integers(20, 90)))).astype(np.float32))
        rows.append({"text": texts[i % 3], "path": path})
    write_manifest(d / "m.jsonl", rows)
    (d / "clean.txt").write_text("\n".join(r["path"] for r in rows[:10]) + "\n")
    (d / "noise.txt").write_text(str(d / "noise") + "\n")
    return d


def _equal_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_clvp_dataset_batches_equal(sidecars):
    m = str(sidecars / "m.jsonl")
    ds, jds = datasets.CLVPDataset(m), jdatasets.CLVPDataset(m)
    assert ds.lengths() == jds.lengths()
    assert ds[4] is None and jds[4] is None
    want = list(jmains._bucketed_batches(jds, 3, 5, range(0, 641, 64)).make_loader(0))
    got = list(mains._bucketed_batches(ds, 3, 5, range(0, 641, 64)).make_loader(0))
    _equal_batches(got, want)


def test_mel_dataset_batches_equal(sidecars):
    """JAX's loader maps __getitem__ over 4 threads, which may reorder the
    crops' draws among a batch's rows; the reference is its index lists
    taken in order, which the port's classifier loader (one worker)
    follows."""
    clean, noise = str(sidecars / "clean.txt"), str(sidecars / "noise.txt")
    mk = lambda mod: mod.PreprocessedMelDataset(clean, noise, pad_to=48,  # noqa: E731
                                                rng=np.random.default_rng(9))
    ds, jds = mk(datasets), mk(jdatasets)
    assert ds.items == jds.items and len(ds) == 14
    lists = list(jmains._simple_batches(jds, 4, 9).make_loader(0).batch_sampler)
    want = [jds.collate([jds[i] for i in idxs]) for idxs in lists]
    got = list(mains._simple_batches(ds, 4, 9, num_workers=1).make_loader(0))
    _equal_batches(got, want)
    assert {int(v) for b in got for v in b["labels"]} == {0, 1}


# ------------------------------------------------------------------ porting


@pytest.mark.parametrize("which", ["xformers", "plain", "classifier"])
def test_variables_round_trip_and_export_loads_in_jax(which, tmp_path):
    from ttts_tpu.config import TTTSConfig

    import flax

    if which == "classifier":
        variables, name = _cls_variables(), "classifier"
        jcfg = dataclasses.replace(JTINY, classifier=CLS_C)
    else:
        variables, name = _clvp_variables(which), "clvp"
        jcfg = dataclasses.replace(JTINY, clvp=FLAVOURS[which])
    assert isinstance(jcfg, TTTSConfig)
    sd = porting.STATE_DICT_FNS[name](variables)
    back = porting.VARIABLES_FNS[name](sd)
    fa = flax.traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray, variables))
    fb = flax.traverse_util.flatten_dict(back)
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k])
    export_model(name, sd, tmp_path / f"{name}.npz")
    jmodel, jvars = jload_model(name, str(tmp_path / f"{name}.npz"), jcfg)
    port, _ = load_model(name, tmp_path / f"{name}.npz", to_port(jcfg))
    if name == "clvp":
        b = _clvp_batch(seed=8)
        want = np.asarray(jmodel.apply(jvars, jnp.asarray(b["text"]),
                                       jnp.asarray(b["speech_tokens"])))
        from ttts_tpu_torch.api import TextToSpeech

        tts = TextToSpeech.from_checkpoints(to_port(jcfg), clvp=tmp_path / "clvp.npz",
                                            device="cpu")
        with torch.no_grad():
            got = port(*_torch(b).values()).numpy()
            served = tts.clvp(*_torch(b).values()).numpy()
        np.testing.assert_array_equal(served, got)
    else:
        b = _mel_batch(seed=4)
        want = np.asarray(jmodel.apply(jvars, jnp.asarray(b["mel"])))
        with torch.no_grad():
            got = port(torch.from_numpy(b["mel"])).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
