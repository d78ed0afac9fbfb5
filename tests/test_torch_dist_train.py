"""Data-parallel training of the port on gloo worlds of 2 CPU processes at
TINY widths: every train step (GPT, diffusion, CLVP, classifier, the codec
GAN) on 2 ranks, each with its half of a global batch of 4, against one
process on the whole batch, from the same weights and the same key:

- the loss within 2e-5 and the grad norm within 2e-4 (relative), as
  tests/test_multihost.py:87-90 holds JAX's; the GAN's seven losses within
  2e-5 (relative, 1e-6 absolute);
- every parameter after the step within 1e-5, and equal across the ranks
  bit for bit; the optimizers are AdamW with eps 1, whose first update is
  about lr * g, so that the parameters carry the averaged gradient's value
  and not only its sign;
- the GAN's codebook (k-means init on the global pool, the EMA update, the
  dead-code replacements) equal across the ranks and within 1e-5 of the
  single process; the CLVP's InfoNCE is the global batch's;
- (the "trainer" world, run by tests/test_torch_trainer.py) a Trainer on a
  (data=2) mesh trains, saves once (rank 0 writes), resumes on both ranks
  and logs per rank;
- two processes of `python -m ttts_tpu_torch.train.mains gpt` with
  WORLD_SIZE=2, RANK and MASTER_ADDR / MASTER_PORT take one step whose loss
  matches one process on the union of their batches.

Dropout is off (dropout masks are drawn per rank, see train/steps.py).
"""

from __future__ import annotations

import ast
import dataclasses
import json
import math
import os
import pathlib
import re
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from test_torch_parallel import ROOT, run_world, torch_threads, worker_main  # noqa: F401

KEY = 1234
LOSS_TOL, NORM_TOL, PARAM_TOL = 2e-5, 2e-4, 1e-5
MODELS = ("gpt", "diffusion", "clvp", "classifier", "gan")
PERIODS, P_CH = (2, 3), (8, 16, 32, 32)
S_SPECS = ((8, 15, 1, 1), (16, 41, 4, 4), (32, 41, 4, 16), (32, 5, 1, 1))
SEG = 4


def no_dropout(model: torch.nn.Module) -> torch.nn.Module:
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
        if hasattr(m, "dropout") and isinstance(m.dropout, float):
            m.dropout = 0.0
    return model


def _seeded(seed, fn):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return no_dropout(fn())


def build(cfg, name):
    """(state, step function) of `name`, with the same weights in every
    process: the state's optimizers are AdamW with eps 1."""
    import functools

    from ttts_tpu_torch.diffusion.gaussian import GaussianDiffusion, get_named_beta_schedule
    from ttts_tpu_torch.models.classifier import AudioMiniEncoderWithClassifierHead
    from ttts_tpu_torch.models.clvp import CLVP
    from ttts_tpu_torch.models.diffusion_net import AA_diffusion
    from ttts_tpu_torch.models.discriminator import MultiPeriodDiscriminator
    from ttts_tpu_torch.models.gpt import UnifiedVoice
    from ttts_tpu_torch.models.vqvae import SynthesizerTrn
    from ttts_tpu_torch.train import steps
    from ttts_tpu_torch.train.state import GanState, TrainState, make_adamw, make_gan_adam

    adam = lambda ps: make_adamw(ps, 0.05, warmup_steps=1, eps=1.0)  # noqa: E731
    if name == "gpt":
        return (TrainState.create(_seeded(0, lambda: UnifiedVoice(cfg.gpt)), adam, ema=True),
                steps.gpt_train_step)
    if name == "diffusion":
        gpt = _seeded(0, lambda: UnifiedVoice(cfg.gpt)).eval().requires_grad_(False)
        diffuser = GaussianDiffusion(betas=get_named_beta_schedule("linear", 50))
        return (TrainState.create(_seeded(1, lambda: AA_diffusion(cfg.diffusion_net)), adam),
                functools.partial(steps.diffusion_train_step, diffuser=diffuser, gpt_model=gpt,
                                  unconditioned_percentage=0.5))
    if name == "clvp":
        return TrainState.create(_seeded(2, lambda: CLVP(cfg.clvp)), adam), steps.clvp_train_step
    if name == "classifier":
        return (TrainState.create(_seeded(3, lambda: AudioMiniEncoderWithClassifierHead(
            cfg.classifier)), adam), steps.classifier_train_step)
    gen = _seeded(4, lambda: SynthesizerTrn(cfg.vqvae, spec_channels=cfg.audio.filter_length
                                            // 2 + 1, segment_frames=SEG, for_training=True))
    disc = _seeded(5, lambda: MultiPeriodDiscriminator(PERIODS, P_CH, S_SPECS))
    gan = lambda ps: make_gan_adam(ps, 0.05, eps=1.0)  # noqa: E731
    return (GanState(TrainState.create(gen, gan), TrainState.create(disc, gan)),
            functools.partial(steps.vqvae_train_step, audio_cfg=cfg.audio))


def batches(cfg, b: int = 4):
    """The global batch of each model (numpy, seeded)."""
    rng = np.random.default_rng(0)
    g = cfg.gpt
    gpt = {"text": rng.integers(1, 200, (b, 12)), "text_lengths": np.asarray([12, 9, 11, 7]),
           "mel_codes": rng.integers(0, g.number_mel_codes - 2, (b, 16)),
           "wav_lengths": np.asarray([16, 12, 14, 9]) * 1024}
    mels = cfg.diffusion_net.in_channels
    diff = dict(gpt, mel=rng.standard_normal((b, 32, mels)).astype(np.float32) - 2.0,
                mel_refer=rng.standard_normal((b, 24, mels)).astype(np.float32) - 2.0)
    clvp = {"text": rng.integers(1, 200, (b, 10)), "speech_tokens": rng.integers(0, 1024, (b, 24))}
    cls = {"mel": rng.standard_normal((b, 64, cfg.classifier.spec_dim)).astype(np.float32),
           "labels": np.asarray([0, 1, 1, 0])}
    hop, frames = cfg.audio.hop_length, 8
    gan = {"wav": (rng.standard_normal((b, frames * hop, 1)) * 0.1).astype(np.float32),
           "spec_lengths": np.asarray([8, 6, 8, 4]),
           "text": rng.integers(0, cfg.vqvae.n_text_tokens, (b, 16)),
           "text_lengths": np.asarray([16, 9, 12, 16])}
    return {"gpt": gpt, "diffusion": diff, "clvp": clvp, "classifier": cls, "gan": gan}


def _tensors(batch, rows=slice(None)):
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v[rows]))
        out[k] = t if t.is_floating_point() else t.long()
    return out


def snapshot(state, name):
    """The parameters and buffers of the state's model(s)."""
    models = {"g": state.g.model, "d": state.d.model} if name == "gan" else {"m": state.model}
    return {f"{m}.{k}": v.detach().clone() for m, mod in models.items()
            for k, v in mod.state_dict().items()}


def run_step(cfg, name, batch, mesh=None):
    """One step → (metrics as floats, the parameters and buffers after it)."""
    state, step = build(cfg, name)
    metrics = step(state, batch, KEY, mesh=mesh)
    return {k: float(v) for k, v in metrics.items()}, snapshot(state, name)


def _steps(tmp, rank, world):
    from ttts_tpu_torch.config import MeshConfig
    from ttts_tpu_torch.parallel import make_mesh

    cfg = torch.load(tmp / "cfg.pt", weights_only=False)
    mesh = make_mesh(MeshConfig(data=2, model=1))
    half = batches(cfg)
    rows = slice(2 * rank, 2 * rank + 2)
    return {name: run_step(cfg, name, _tensors(half[name], rows), mesh) for name in MODELS}


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.linspace(-1.0, 1.0, 6))


def _tiny_step(state, batch, key, mesh=None):
    """A least-squares step through the data-parallel path of the steps."""
    from ttts_tpu_torch.train.steps import _grads, _mean_over_ranks, apply_gradients_safe

    loss = ((batch["x"] @ state.model.w.reshape(6, 1) - batch["y"]) ** 2).mean()
    grads, (loss,) = _mean_over_ranks(mesh, _grads(loss, state.params), loss)
    norm, finite, _ = apply_gradients_safe(state, grads)
    return {"loss": loss, "grad_norm": norm, "nonfinite_skipped": 0.0 if finite else 1.0}


def _trainer(tmp, rank, world):
    """A (data=2) Trainer: 1 step and a save, then a resumed second step;
    which ranks called torch.save."""
    from ttts_tpu_torch.config import MeshConfig
    from ttts_tpu_torch.parallel import make_mesh
    from ttts_tpu_torch.train import checkpoints
    from ttts_tpu_torch.train.state import TrainState, make_adamw
    from ttts_tpu_torch.train.trainer import Trainer

    saves = []
    real_save = checkpoints.torch.save
    checkpoints.torch.save = lambda *a, **k: (saves.append(rank), real_save(*a, **k))
    mesh = make_mesh(MeshConfig(data=2))
    rng = np.random.default_rng(rank)
    data = [{"x": rng.standard_normal((3, 6)).astype(np.float32),
             "y": rng.standard_normal((3, 1)).astype(np.float32)} for _ in range(4)]
    out = {}
    for steps in (1, 2):
        state = TrainState.create(_Tiny(), lambda ps: make_adamw(ps, 1e-2, warmup_steps=1))
        tr = Trainer(_tiny_step, state, data, str(tmp / "logs"), steps, save_freq=1,
                     log_every=1, mesh=mesh, device="cpu")
        tr.maybe_resume()
        out[f"start_{steps}"] = tr.step
        tr.train()
        out[f"w_{steps}"] = state.model.w.detach().clone()
        out[f"loss_{steps}"] = float(tr.history[-1]["loss"])
    checkpoints.torch.save = real_save
    out["saves"] = list(saves)
    return out


def uneven_examples(cfg):
    """The examples of a global batch of 4 of the GPT and the codec GAN, in
    the datasets' layouts, whose halves (rows 0-1 and 2-3) collate to
    different shapes: long rows on rank 0, short ones on rank 1."""
    from ttts_tpu_torch.data.datasets import GptExample

    rng = np.random.default_rng(7)
    hop = cfg.audio.hop_length
    gpt = [GptExample(rng.integers(1, 200, lt).astype(np.int32),
                      rng.integers(0, cfg.gpt.number_mel_codes - 2, lm).astype(np.int32),
                      lm * 1024) for lt, lm in ((36, 40), (20, 30), (12, 20), (9, 14))]
    gan = [{"wav": (rng.standard_normal(f * hop) * 0.1).astype(np.float32),
            "text": rng.integers(0, cfg.vqvae.n_text_tokens, lt).astype(np.int32)}
           for f, lt in ((16, 20), (12, 9), (7, 5), (5, 3))]
    return {"gpt": gpt, "gan": gan}


def collate(cfg, name, examples):
    """The dataset's own collate of `examples` (each pads to its longest row)."""
    import types

    from ttts_tpu_torch.data.datasets import GptTtsDataset, VQGANDataset

    if name == "gpt":
        return GptTtsDataset.collate(None, examples)
    return VQGANDataset.collate(types.SimpleNamespace(hop=cfg.audio.hop_length), examples)


def _uneven(tmp, rank, world):
    """A (data=2) Trainer step of the GPT and of the GAN on this rank's half
    of uneven_examples, collated on its own: rank 1's arrays are shorter."""
    from ttts_tpu_torch.config import MeshConfig
    from ttts_tpu_torch.parallel import make_mesh
    from ttts_tpu_torch.train.trainer import Trainer

    cfg = torch.load(tmp / "cfg.pt", weights_only=False)
    mesh = make_mesh(MeshConfig(data=2, model=1))
    out = {}
    for name, ex in uneven_examples(cfg).items():
        state, step = build(cfg, name)
        batch = collate(cfg, name, ex[2 * rank:2 * rank + 2])
        tr = Trainer(step, state, [batch], str(tmp / f"logs_{name}"), 1, log_every=1,
                     mesh=mesh, device="cpu")
        tr.train()
        out[name] = ({k: float(v) for k, v in tr.history[-1].items() if k != "step"
                      and k != "seconds"}, snapshot(state, name),
                     {k: v.shape for k, v in batch.items()})
    return out


SCENARIOS = {"steps": _steps, "trainer": _trainer, "uneven": _uneven}


@pytest.fixture(scope="module")
def cfg():
    from test_api import TINY as JTINY
    from test_torch_config import to_port

    c = to_port(JTINY)
    return dataclasses.replace(
        c, gpt=dataclasses.replace(c.gpt, dropout=0.0),
        clvp=dataclasses.replace(c.clvp, text_mask_percentage=0.2, voice_mask_percentage=0.3),
        classifier=dataclasses.replace(c.classifier, embedding_dim=64, depth=2,
                                       base_channels=16, attn_blocks=1, num_attn_heads=2,
                                       kernel_size=3))


@pytest.fixture(scope="module")
def stepped(cfg, tmp_path_factory):
    """(each rank's (metrics, state after)), the single process's and the
    states before the step."""
    tmp = tmp_path_factory.mktemp("dp_steps")
    torch.save(cfg, tmp / "cfg.pt")
    ranks = run_world(pathlib.Path(__file__), "steps", 2, tmp, timeout=150)
    single = {name: run_step(cfg, name, _tensors(b)) for name, b in batches(cfg).items()}
    initial = {name: snapshot(build(cfg, name)[0], name) for name in MODELS}
    return ranks, single, initial


def _close(got, want, tol):
    assert abs(got - want) <= tol * abs(want) + 1e-6, (got, want)


@pytest.mark.parametrize("name", MODELS)
def test_step_matches_single_process(stepped, name):
    ranks, single, initial = stepped
    want_m, want_p = single[name]
    for out in ranks:
        got_m, got_p = out[name]
        assert got_m.keys() == want_m.keys()
        for k, v in want_m.items():
            _close(got_m[k], v, NORM_TOL if k == "grad_norm" else LOSS_TOL)
        assert got_m.get("nonfinite_skipped", 0.0) == 0.0
        assert got_p.keys() == want_p.keys()
        for k, v in want_p.items():
            np.testing.assert_allclose(got_p[k].double().numpy(), v.double().numpy(),
                                       atol=PARAM_TOL, rtol=0, err_msg=f"{name} {k}")
            torch.testing.assert_close(got_p[k], ranks[0][name][1][k], rtol=0, atol=0)
    moved = max(float((want_p[k].double() - initial[name][k].double()).abs().max())
                for k in want_p if want_p[k].is_floating_point())
    assert moved > 10 * PARAM_TOL, f"{name}: the step barely moved the parameters"


def test_gan_codebook_is_global(stepped):
    """The k-means init and the EMA statistics are the global batch's: the
    codebook equals the single process's, and every code's cluster size
    counts rows of both ranks."""
    ranks, single, _ = stepped
    prefix = "g.quantizer.vq.layers."
    keys = [k for k in single["gan"][1] if k.startswith(prefix)]
    assert any(k.endswith("cluster_size") for k in keys)
    for k in keys:
        want = single["gan"][1][k]
        for out in ranks:
            got = out["gan"][1][k]
            torch.testing.assert_close(got, ranks[0]["gan"][1][k], rtol=0, atol=0)
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def uneven(cfg, tmp_path_factory):
    """(each rank's Trainer step on its own collate of uneven_examples, the
    single process's step on the collate of all four)."""
    tmp = tmp_path_factory.mktemp("dp_uneven")
    torch.save(cfg, tmp / "cfg.pt")
    ranks = run_world(pathlib.Path(__file__), "uneven", 2, tmp, timeout=150)
    key = int(torch.randint(2 ** 62, (1,), generator=torch.Generator().manual_seed(1234)))
    single = {}
    for name, ex in uneven_examples(cfg).items():
        state, step = build(cfg, name)
        metrics = step(state, _tensors(collate(cfg, name, ex)), key)
        single[name] = {k: float(v) for k, v in metrics.items()}, snapshot(state, name)
    return ranks, single


@pytest.mark.parametrize("name", ["gpt", "gan"])
def test_uneven_padding_matches_single_process(uneven, name):
    """Ranks whose batches pad to different lengths (the bucket samplers
    stride a bucket by rank, and each collate pads to its own longest row):
    the Trainer pads every rank's arrays to the largest shape, so the step
    is the one process's on the collate of all rows, within the tolerances
    of test_step_matches_single_process; the GAN's codebook too."""
    ranks, single = uneven
    want_m, want_p = single[name]
    shapes = [out[name][2] for out in ranks]
    assert shapes[0] != shapes[1], "the ranks' batches must differ in shape"
    for out in ranks:
        got_m, got_p, _ = out[name]
        for k, v in want_m.items():
            _close(got_m[k], v, NORM_TOL if k == "grad_norm" else LOSS_TOL)
        for k, v in want_p.items():
            np.testing.assert_allclose(got_p[k].double().numpy(), v.double().numpy(),
                                       atol=PARAM_TOL, rtol=0, err_msg=f"{name} {k}")
            torch.testing.assert_close(got_p[k], ranks[0][name][1][k], rtol=0, atol=0)
    if name == "gan":
        assert any(k.startswith("g.quantizer.vq.layers.") for k in want_p)


# ------------------------------------------------------------- the CLI


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


TEXTS = ["ni3 hao3 shi4 jie4", "jin1 tian1 tian1 qi4", "wo3 men5 qu4 gong1 yuan2",
         "ni3 hao3 ma5"]


@pytest.fixture(scope="module")
def uneven_corpus(tmp_path_factory):
    """16 utterances in one length bucket, the first 8 of 40-63 codes, the
    others of 20-31: a batch pads its codes to 64 or to 32, so two ranks'
    batches may differ in shape."""
    from ttts_tpu_torch.data.manifest import save_sidecar, write_manifest

    d = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    rows = []
    for i in range(16):
        path = str(d / f"u{i:02d}.wav")
        n = int(rng.integers(40, 64)) if i < 8 else int(rng.integers(20, 32))
        save_sidecar(path, "vq", rng.integers(0, 1024, n))
        rows.append({"text": TEXTS[i % 4], "path": path})
    write_manifest(d / "m.jsonl", rows)
    return str(d / "m.jsonl")


def _cli_loss(log: pathlib.Path) -> float:
    lines = [ln for ln in log.read_text().splitlines() if re.search(r" step 1 \{", ln)]
    assert lines, log.read_text()[-2000:]
    return float(re.search(r"'loss': ([-0-9.e]+)", lines[-1]).group(1))


def _run_cli(args, tmp_path, timeout: float = 150.0):
    """Two processes of `python -m ttts_tpu_torch.train.mains *args` (RANK 0
    and 1 of WORLD_SIZE 2, a free port on localhost), killed after
    `timeout` seconds; raises with a failing rank's output."""
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    outs = [open(tmp_path / f"out_{r}.txt", "w") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, "-m", "ttts_tpu_torch.train.mains", *args],
                              env=dict(env, RANK=str(r)), stdout=outs[r],
                              stderr=subprocess.STDOUT, cwd=str(ROOT)) for r in range(2)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in outs:
            f.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (tmp_path / f"out_{r}.txt").read_text()[-4000:]


def test_cli_two_processes_match_one(cfg, uneven_corpus, tmp_path):
    """Two processes of the CLI, whose first batches pad to different
    lengths, take the step of one process on the collate of both batches'
    rows."""
    from ttts_tpu_torch.data.datasets import GptTtsDataset
    from ttts_tpu_torch.data.sampler import DistributedBucketSampler
    from ttts_tpu_torch.models.gpt import UnifiedVoice
    from ttts_tpu_torch.train import mains
    from ttts_tpu_torch.train.state import TrainState
    from ttts_tpu_torch.train.steps import gpt_train_step

    c = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, train_steps=1,
                                                           save_freq=1, batch_size=4))
    (tmp_path / "cfg.json").write_text(json.dumps(dataclasses.asdict(c)))
    logs = tmp_path / "logs"
    _run_cli(["gpt", "--manifest", uneven_corpus, "--config", str(tmp_path / "cfg.json"),
              "--logs", str(logs), "--device", "cpu"], tmp_path, timeout=120)
    assert (logs / "train.p1.log").exists() and (logs / "tb").exists()
    assert [f.name for f in (logs / "ckpt").iterdir()] == ["step_00000001.pt"]
    loss = _cli_loss(logs / "train.log")
    assert _cli_loss(logs / "train.p1.log") == loss
    # one process: the rows of each rank's first batch (rank 0's first), collated together
    ds = GptTtsDataset(uneven_corpus)
    first = [next(iter(DistributedBucketSampler(ds.lengths(), 2, list(range(0, 641, 64)),
                                                num_replicas=2, rank=r, seed=c.train.seed)))
             for r in range(2)]
    shapes = [ds.collate([ds[i] for i in ids])["mel_codes"].shape for ids in first]
    assert shapes[0] != shapes[1], "the ranks' batches must differ in shape"
    batch = ds.collate([ds[i] for ids in first for i in ids])
    state = TrainState.create(mains._build(UnifiedVoice, c.gpt, c.train.seed, "cpu"),
                              mains._adamw(c, full=True), ema=True)
    key = int(torch.randint(2 ** 62, (1,), generator=torch.Generator().manual_seed(c.train.seed)))
    want = gpt_train_step(state, _tensors(batch), key, c.train.text_weight, c.train.mel_weight)
    _close(loss, float(want["loss"]), LOSS_TOL)


def test_cli_vqvae_two_processes_on_clips_of_different_lengths(cfg, tmp_path_factory, tmp_path):
    """`train.mains vqvae` on two processes whose first batches hold clips
    of different lengths (each rank's collate pads to its own longest
    clip): both take the step, log the same losses and rank 0 saves an
    inited codebook. (The codec's style encoder keeps a dropout of 0.1, so
    the step is held to one process's in the Trainer test above, where
    dropout is off.)"""
    from test_torch_train_data import write_wav_corpus

    from ttts_tpu_torch.data.datasets import VQGANDataset
    from ttts_tpu_torch.train import mains
    from ttts_tpu_torch.train.checkpoints import CheckpointManager

    corpus = write_wav_corpus(tmp_path_factory.mktemp("clips"), rows=10, seed=1)
    c = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, train_steps=1,
                                                           save_freq=1, batch_size=4))
    a = c.audio
    ds = VQGANDataset(corpus, sample_rate=a.sampling_rate, hop_length=a.hop_length)
    shapes = [next(iter(mains.make_vqvae_loader(c, ds, 2, r)))["wav"].shape for r in range(2)]
    assert shapes[0] != shapes[1], "the ranks' batches must differ in shape"
    (tmp_path / "cfg.json").write_text(json.dumps(dataclasses.asdict(c)))
    logs = tmp_path / "logs"
    _run_cli(["vqvae", "--manifest", corpus, "--config", str(tmp_path / "cfg.json"), "--logs",
              str(logs), "--device", "cpu"], tmp_path)
    lines = [(logs / n).read_text() for n in ("train.log", "train.p1.log")]
    losses = [ast.literal_eval(re.search(r" step 1 (\{.*\})", ln).group(1)) for ln in lines]
    for m in losses:  # each process's own clock
        m.pop("seconds", None)
        m.pop("steps_per_sec", None)
    assert losses[0] == losses[1] and all(map(math.isfinite, losses[0].values())), losses
    _, tree = CheckpointManager(logs / "ckpt").restore()
    sd = tree["state"]["g"]["model"]
    assert float(sd["quantizer.vq.layers.0._codebook.inited"][0]) == 1.0
    assert torch.isfinite(sd["quantizer.vq.layers.0._codebook.embed"]).all()


if __name__ == "__main__":
    worker_main(SCENARIOS)
