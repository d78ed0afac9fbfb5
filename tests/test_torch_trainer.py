"""The port's trainer, checkpoints and entry points on the CPU at TINY
widths:

- a run resumed from its step-2 checkpoint ends bit-equal to the
  uninterrupted 4-step run (weights, optimizer state, EMA, losses), for the
  GPT and the diffusion decoder;
- a run of non-finite steps aborts with a checkpoint of the last state;
- SIGTERM flushes a checkpoint and raises PreemptionRequested (in a child
  process, so that the signal cannot reach the test runner);
- export_release of the port's GPT loads in the JAX package's load_release,
  and UnifiedVoice.apply(return_latent=True) on it matches the port's latent
  on the same file (1e-4); the diffusion export holds the JAX init's tree;
- porting: forward ∘ inverse is the identity on both models' trees;
- the CLI trains on the CPU only with --device cpu, and what it trains
  serves through TextToSpeech.from_checkpoints."""

import dataclasses
import json
import pathlib
import subprocess
import sys

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_api import TINY as JTINY
from test_torch_codec_synth import seeded_variables
from test_torch_config import TINY
from ttts_tpu.models import diffusion_net as jdn
from ttts_tpu.models import gpt as jgpt
from ttts_tpu.train.checkpoints import load_release as jload_release
from ttts_tpu_torch import porting
from ttts_tpu_torch.data.manifest import save_sidecar, write_manifest
from ttts_tpu_torch.infer_utils import load_model
from ttts_tpu_torch.train import mains
from ttts_tpu_torch.train.checkpoints import CheckpointManager, export_model
from ttts_tpu_torch.train.state import TrainState, make_adamw
from ttts_tpu_torch.train.trainer import Trainer

ROOT = pathlib.Path(__file__).resolve().parents[1]
TEXTS = ["ni3 hao3 shi4 jie4", "jin1 tian1 tian1 qi4 hen3 hao3", "wo3 men5 qu4 gong1 yuan2"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("train")
    rng = np.random.default_rng(0)
    rows = []
    for i in range(16):
        path = str(d / f"u{i:02d}.wav")
        save_sidecar(path, "vq", rng.integers(0, 1024, int(rng.integers(20, 100))))
        save_sidecar(path, "mel", rng.standard_normal(
            (int(rng.integers(110, 200)), 100)).astype(np.float32) - 3.0)
        rows.append({"text": TEXTS[i % 3], "path": path})
    write_manifest(d / "m.jsonl", rows)
    return str(d / "m.jsonl")


def _cfg(steps, save_freq=2):
    return dataclasses.replace(TINY, train=dataclasses.replace(
        TINY.train, train_steps=steps, save_freq=save_freq, batch_size=4))


def _trainer(which, corpus, logs, steps):
    cfg = _cfg(steps)
    if which == "gpt":
        return mains.gpt_trainer(cfg, corpus, str(logs), device="cpu")
    return mains.diffusion_trainer(cfg, corpus, _gpt_sd(), str(logs), device="cpu")


def _gpt_sd():
    from ttts_tpu_torch.models.gpt import UnifiedVoice

    torch.manual_seed(3)
    return UnifiedVoice(TINY.gpt).state_dict()


@pytest.mark.parametrize("which", ["gpt", "diffusion"])
def test_resume_is_bit_equal(corpus, tmp_path, which):
    full = _trainer(which, corpus, tmp_path / "full", 4)
    full.train()
    half = _trainer(which, corpus, tmp_path / "half", 2)
    half.train()
    assert CheckpointManager(tmp_path / "half" / "ckpt").all_steps() == [2]
    resumed = _trainer(which, corpus, tmp_path / "half", 4)
    assert resumed.step == 2
    resumed.train()
    assert [h["step"] for h in resumed.history] == [3, 4]
    for a, b in zip(list(full.history)[2:], resumed.history):
        assert float(a["loss"]) == float(b["loss"])
    sa, sb = full.state.state_dict(), resumed.state.state_dict()
    assert sa["step"] == sb["step"] == 4
    for k, v in sa["model"].items():
        assert torch.equal(v, sb["model"][k]), k
    moments = lambda sd: sd["optimizer"]["adamw"]["state"]  # noqa: E731
    assert moments(sa).keys() == moments(sb).keys()
    for i, m in moments(sa).items():
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(m[k], moments(sb)[i][k]), (i, k)
    if sa["ema"] is not None:
        for x, y in zip(sa["ema"], sb["ema"]):
            assert torch.equal(x, y)


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(3))


def test_divergence_abort_checkpoints(tmp_path):
    state = TrainState.create(_Tiny(), lambda ps: make_adamw(ps, 1e-3))

    def step(s, batch, key):
        s.step += 1  # as a finite step would; the flag reports the skip
        return {"loss": torch.tensor(float("nan")), "nonfinite_skipped": 1.0}

    tr = Trainer(step, state, iter([{"x": np.zeros(2)}] * 100), str(tmp_path), 50,
                 save_freq=100, max_consecutive_nonfinite=3, device="cpu")
    with pytest.raises(RuntimeError, match="3 consecutive non-finite"):
        tr.train()
    assert tr.ckpt.latest_step() == 3


def test_mesh_of_more_than_one_device_raises(tmp_path):
    state = TrainState.create(_Tiny(), lambda ps: make_adamw(ps, 1e-3))
    with pytest.raises(NotImplementedError, match="item 9"):
        Trainer(lambda *a: {}, state, [], str(tmp_path), 1,
                mesh=dataclasses.replace(TINY.mesh, data=2))


CHILD = r'''
import os, signal, sys
sys.path.insert(0, sys.argv[2])
import numpy as np, torch
from ttts_tpu_torch.train.state import TrainState, make_adamw
from ttts_tpu_torch.train.trainer import PreemptionRequested, Trainer

class M(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(3))

def step(s, batch, key):
    s.step += 1
    if s.step == 2:
        os.kill(os.getpid(), signal.SIGTERM)
    return {"loss": torch.tensor(1.0), "nonfinite_skipped": 0.0}

tr = Trainer(step, TrainState.create(M(), lambda ps: make_adamw(ps, 1e-3)),
             iter([{"x": np.zeros(2)}] * 100), sys.argv[1], 50, save_freq=100, device="cpu")
try:
    tr.train()
except PreemptionRequested as e:
    print("PREEMPTED", tr.ckpt.latest_step(), flush=True)
'''


def test_sigterm_grace_save(tmp_path):
    out = subprocess.run([sys.executable, "-c", CHILD, str(tmp_path), str(ROOT)],
                         capture_output=True, text=True, timeout=120)
    assert "PREEMPTED 2" in out.stdout, out.stderr[-2000:]
    assert CheckpointManager(tmp_path / "ckpt").all_steps() == [2]


def _gpt_args(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(1, 200, (2, 10)).astype(np.int32), np.asarray([10, 7], np.int32),
            rng.integers(0, 1024, (2, 24)).astype(np.int32),
            np.asarray([24 * 1024, 15 * 1024], np.int32))


def test_export_release_loads_in_jax(tmp_path):
    from ttts_tpu_torch.models.gpt import UnifiedVoice

    torch.manual_seed(4)
    path = tmp_path / "gpt.npz"
    export_model("gpt", UnifiedVoice(TINY.gpt).state_dict(), path, config={"stage": "gpt"})
    tree, cfg = jload_release(path)
    assert cfg == {"stage": "gpt"}
    args = _gpt_args()
    want = jgpt.UnifiedVoice(JTINY.gpt).apply(tree, *(jnp.asarray(a) for a in args),
                                              return_latent=True)
    port, _ = load_model("gpt", path, TINY)
    with torch.no_grad():
        got = port(*(torch.as_tensor(a).long() for a in args), return_latent=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    # the diffusion export: the JAX init's tree, leaf for leaf
    from ttts_tpu_torch.models.diffusion_net import AA_diffusion

    export_model("diffusion", AA_diffusion(TINY.diffusion_net).state_dict(),
                 tmp_path / "diffusion.npz")
    dtree, _ = jload_release(tmp_path / "diffusion.npz")
    mel = jnp.zeros((1, 32, 100))
    shapes = jax.eval_shape(lambda: jdn.AA_diffusion(JTINY.diffusion_net).init(
        jax.random.key(0), mel, jnp.asarray([1.0]), jnp.zeros((1, 16, 64)), mel))
    flat = flax.traverse_util.flatten_dict(shapes)
    got_flat = flax.traverse_util.flatten_dict(dtree)
    assert flat.keys() == got_flat.keys()
    assert all(got_flat[k].shape == v.shape for k, v in flat.items())


@pytest.mark.parametrize("which", ["gpt", "diffusion"])
def test_porting_forward_inverse_is_identity(which):
    if which == "gpt":
        init = lambda: jgpt.UnifiedVoice(JTINY.gpt).init(  # noqa: E731
            jax.random.key(0), *(jnp.asarray(a) for a in _gpt_args()))
    else:
        mel = jnp.zeros((1, 32, 100))
        init = lambda: jdn.AA_diffusion(JTINY.diffusion_net).init(  # noqa: E731
            jax.random.key(0), mel, jnp.asarray([1.0]), jnp.zeros((1, 16, 64)), mel)
    variables = seeded_variables(init)
    sd = porting.STATE_DICT_FNS[which](variables)
    back = porting.VARIABLES_FNS[which](sd)
    fa = flax.traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray, variables))
    fb = flax.traverse_util.flatten_dict(back)
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k])
    again = porting.STATE_DICT_FNS[which](back)
    assert again.keys() == sd.keys() and all(np.array_equal(again[k], sd[k]) for k in sd)


def test_cli_trains_on_cpu_and_serves(corpus, tmp_path):
    from ttts_tpu_torch.api import TextToSpeech

    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(dataclasses.asdict(_cfg(2, save_freq=1))))
    with pytest.raises(NotImplementedError, match="item 7"):
        mains.main(["vqvae", "--manifest", corpus])
    if not torch.cuda.is_available():  # the card is the default device
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mains.main(["gpt", "--manifest", corpus, "--config", str(cfg), "--logs",
                        str(tmp_path / "nope")])
    base = ["--manifest", corpus, "--config", str(cfg), "--device", "cpu"]
    mains.main(["gpt", *base, "--logs", str(tmp_path / "gpt")])
    mains.main(["diffusion", *base, "--logs", str(tmp_path / "diff"),
                "--gpt-ckpt", str(tmp_path / "gpt" / "ckpt")])
    assert CheckpointManager(tmp_path / "diff" / "ckpt").all_steps() == [1, 2]
    gpt_sd = mains.load_gpt_state_dict(tmp_path / "gpt")
    _, tree = CheckpointManager(tmp_path / "diff" / "ckpt").restore()
    export_model("gpt", gpt_sd, tmp_path / "gpt.npz")
    export_model("diffusion", tree["state"]["model"], tmp_path / "diffusion.npz")
    tts = TextToSpeech.from_checkpoints(TINY, gpt=tmp_path / "gpt.npz",
                                        diffusion=tmp_path / "diffusion.npz", device="cpu")
    for k, v in tts.gpt.state_dict().items():
        np.testing.assert_allclose(v.numpy(), gpt_sd[k].half().float().numpy(), err_msg=k)
    rng = np.random.default_rng(0)
    wav = tts.tts(TEXTS[0], (0.1 * rng.standard_normal(32000)).astype(np.float32), 32000,
                  preset="ultra_fast", max_generate_length=16, seed=0)
    assert wav.size and np.isfinite(wav).all()
