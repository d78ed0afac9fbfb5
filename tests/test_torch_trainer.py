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
  serves through TextToSpeech.from_checkpoints;
- the codec GAN (its paired generator / discriminator state): a resumed run
  ends bit-equal to the uninterrupted one (both models, both optimizers,
  the codebook, the losses); `train.mains vqvae --device cpu` trains 2 steps
  on a wav corpus, and its export_model("vqvae") release, loaded by the JAX
  package, gives the port's extract_code codes; the codec and
  discriminator maps' forward ∘ inverse is the identity."""

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
from test_torch_train_data import write_wav_corpus
from test_torch_vqvae_train import torch_threads  # noqa: F401 (autouse)
from ttts_tpu.models import diffusion_net as jdn
from ttts_tpu.models import discriminator as jdisc
from ttts_tpu.models import gpt as jgpt
from ttts_tpu.models import vqvae as jvqvae
from ttts_tpu.models.quantize import rvq_state_from_dict
from ttts_tpu.train.checkpoints import load_release as jload_release
from ttts_tpu_torch import porting
from ttts_tpu_torch.data.manifest import save_sidecar, write_manifest
from ttts_tpu_torch.infer_utils import load_model
from ttts_tpu_torch.models import vqvae
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


def test_mesh_of_two_data_ranks_trains_and_saves(tmp_path):
    """A MeshConfig(data=2) Trainer on a 2-rank gloo world trains one step
    and saves once (rank 0 writes), then both ranks resume from it
    (test_torch_dist_train.py's "trainer" world)."""
    import test_torch_dist_train as dist_train

    outs = dist_train.run_world(pathlib.Path(dist_train.__file__), "trainer", 2, tmp_path,
                                timeout=90)
    logs = tmp_path / "logs"
    assert outs[0]["saves"] == [0, 0] and outs[1]["saves"] == []
    assert CheckpointManager(logs / "ckpt").all_steps() == [1, 2]
    assert (logs / "train.log").exists() and (logs / "train.p1.log").exists()
    assert (logs / "tb" / "scalars.jsonl").exists()
    assert [o["start_1"] for o in outs] == [0, 0] and [o["start_2"] for o in outs] == [1, 1]
    for k in ("w_1", "w_2"):
        torch.testing.assert_close(outs[1][k], outs[0][k], rtol=0, atol=0)
    assert not torch.equal(outs[0]["w_1"], outs[0]["w_2"])
    assert outs[0]["loss_1"] == outs[1]["loss_1"]


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
    if not torch.cuda.is_available():  # the card is the default device
        for model in ("gpt", "clvp"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                mains.main([model, "--manifest", corpus, "--config", str(cfg), "--logs",
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


# ------------------------------------------------------------- codec GAN


@pytest.fixture(scope="module")
def wav_corpus(tmp_path_factory):
    return write_wav_corpus(tmp_path_factory.mktemp("gan"), rows=10, seed=1)


def _gan_cfg(steps, save_freq=2):
    return dataclasses.replace(TINY, train=dataclasses.replace(
        TINY.train, train_steps=steps, save_freq=save_freq, batch_size=2))


def test_gan_resume_is_bit_equal(wav_corpus, tmp_path):
    """TINY's codec and the full MultiPeriodDiscriminator, the device warp
    and the EQ on (TINY's train config), the k-means init in step 1."""
    full = mains.vqvae_trainer(_gan_cfg(4), wav_corpus, str(tmp_path / "full"), "cpu")
    full.train()
    half = mains.vqvae_trainer(_gan_cfg(2), wav_corpus, str(tmp_path / "half"), "cpu")
    half.train()
    resumed = mains.vqvae_trainer(_gan_cfg(4), wav_corpus, str(tmp_path / "half"), "cpu")
    assert resumed.step == 2
    resumed.train()
    assert [h["step"] for h in resumed.history] == [3, 4]
    for a, b in zip(list(full.history)[2:], resumed.history):
        for k in ("loss_disc", "loss_gen_all", "loss_mel", "commit_loss"):
            assert float(a[k]) == float(b[k]), k
    sa, sb = full.state.state_dict(), resumed.state.state_dict()
    for side in ("g", "d"):
        assert sa[side]["step"] == sb[side]["step"] == 4
        for k, v in sa[side]["model"].items():
            assert torch.equal(v, sb[side]["model"][k]), (side, k)
        ma, mb = (sd[side]["optimizer"]["adamw"]["state"] for sd in (sa, sb))
        assert ma.keys() == mb.keys()
        for i in ma:
            for k in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(ma[i][k], mb[i][k]), (side, i, k)
    assert bool(sa["g"]["model"]["quantizer.vq.layers.0._codebook.inited"])


def _extract_inputs(seed=2, frames=12):
    from ttts_tpu_torch.ops.mel import vits_spectrogram

    a = TINY.audio
    wav = (0.3 * np.random.default_rng(seed).standard_normal((1, frames * a.hop_length))
           ).astype(np.float32)
    spec = vits_spectrogram(torch.tensor(wav), a.filter_length, a.hop_length,
                            a.win_length).transpose(1, 2).numpy()
    return wav[..., None], spec, np.asarray([frames], np.int32)


def test_cli_trains_vqvae_on_cpu_and_exports(wav_corpus, tmp_path):
    from ttts_tpu_torch.models.vqvae import SynthesizerTrn

    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(dataclasses.asdict(_gan_cfg(2, save_freq=1))))
    mains.main(["vqvae", "--manifest", wav_corpus, "--config", str(cfg), "--logs",
                str(tmp_path / "gan"), "--device", "cpu"])
    ckpt = CheckpointManager(tmp_path / "gan" / "ckpt")
    assert ckpt.all_steps() == [1, 2]
    _, tree = ckpt.restore()
    sd = tree["state"]["g"]["model"]
    assert any(k.startswith("enc_q.") for k in sd) and float(sd[
        "quantizer.vq.layers.0._codebook.inited"][0]) == 1.0
    export_model("vqvae", sd, tmp_path / "codec.npz", config={"stage": "vqvae"})
    jtree, jcfg = jload_release(tmp_path / "codec.npz")
    assert jcfg == {"stage": "vqvae"} and "enc_q" not in jtree["params"]
    wav, spec, lengths = _extract_inputs()
    jmodel = jvqvae.SynthesizerTrn(JTINY.vqvae, spec_channels=JTINY.audio.filter_length // 2 + 1)
    want = np.asarray(jmodel.apply(rvq_state_from_dict(jtree), jnp.asarray(wav),
                                   jnp.asarray(spec), jnp.asarray(lengths),
                                   method=jmodel.extract_code))
    port, _ = load_model("vqvae", tmp_path / "codec.npz", TINY)
    trained = SynthesizerTrn(TINY.vqvae, spec_channels=TINY.audio.filter_length // 2 + 1,
                             segment_frames=4, for_training=True)
    trained.load_state_dict(sd)
    with torch.no_grad():
        args = (torch.tensor(wav), torch.tensor(spec), torch.tensor(lengths).long())
        got = port.extract_code(*args).numpy()
        own = trained.eval().extract_code(*args).numpy()
    assert want.shape == got.shape == (1, TINY.vqvae.n_q, 6)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(own, want)


@pytest.mark.parametrize("which", ["codec_training", "codec_serving", "discriminator"])
def test_gan_maps_forward_inverse_identity(which):
    """JAX variables → state dict → JAX variables, leaf for leaf, and state
    dict → variables → state dict, exactly. The training codec's state dict
    without enc_q loads into a serving codec as it is (one layout)."""
    from test_torch_vqvae_train import training_variables

    if which == "discriminator":
        seg = jnp.zeros((1, 2560, 1))
        variables = seeded_variables(lambda: jdisc.MultiPeriodDiscriminator(periods=(2, 3)).init(
            jax.random.key(0), seg, seg))
        sd = porting.discriminator_state_dict(variables)
        back = porting.VARIABLES_FNS["discriminator"](sd)
        again = porting.discriminator_state_dict(back)
    else:
        training = which == "codec_training"
        model = jvqvae.SynthesizerTrn(JTINY.vqvae, spec_channels=513, segment_frames=4)
        variables = training_variables(model, seed=4)
        if not training:
            variables["params"].pop("enc_q")
        variables = jax.tree_util.tree_map(np.asarray, variables)
        variables["codebook"]["quantizer"]["state"] = {
            k: np.asarray(getattr(variables["codebook"]["quantizer"]["state"], k))
            for k in ("embed", "embed_avg", "cluster_size", "inited")}
        sd = porting.synthesizer_trn_state_dict(variables, for_training=training)
        back = porting.VARIABLES_FNS["vqvae"](sd)
        again = porting.synthesizer_trn_state_dict(back, for_training=training)
    fa = flax.traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray, variables))
    fb = flax.traverse_util.flatten_dict(back)
    assert set(fa) == set(fb), (set(fa) ^ set(fb))
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=str(k))
    assert again.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(again[k], sd[k], err_msg=k)
    if which == "codec_training":
        serving = vqvae.SynthesizerTrn(TINY.vqvae, spec_channels=513, segment_frames=4)
        serving.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()
                                 if not k.startswith("enc_q.")})
