"""Training entry points of the GPT and the diffusion decoder, port of
ttts_tpu/train/mains.py (46-132, 133-185, 215-259, 426-464):

  python -m ttts_tpu_torch.train.mains gpt       --manifest data.jsonl [--config cfg.json]
  python -m ttts_tpu_torch.train.mains diffusion --manifest data.jsonl --gpt-ckpt logs/ckpt

--logs sets the logs folder (checkpoints under <logs>/ckpt, scalars under
<logs>/tb, train.log). --gpt-ckpt is a checkpoint directory of this package's
GPT training or a release `.npz` (export_release). Training runs on the
card unless --device cpu is given; on the card the forward computes in
bf16 under autocast over f32 weights (cfg.train.amp), as the JAX package's
`_amp_dtype` does on an accelerator. vqvae, clvp and classifier training
are not ported yet (ROADMAP.md queue 1, item 7).
"""

from __future__ import annotations

import argparse
import functools
import pathlib
from typing import Dict, Optional

import numpy as np
import torch

from ttts_tpu_torch.config import TTTSConfig, default_config, load_config
from ttts_tpu_torch.data.datasets import DiffusionDataset, GptTtsDataset
from ttts_tpu_torch.data.loader import DataLoader, EpochLoader
from ttts_tpu_torch.data.sampler import DistributedBucketSampler
from ttts_tpu_torch.infer_utils import load_state_dict, prepare_device
from ttts_tpu_torch.train.checkpoints import CheckpointManager
from ttts_tpu_torch.train.state import TrainState, make_adamw, with_accumulation
from ttts_tpu_torch.train.steps import diffusion_train_step, gpt_train_step
from ttts_tpu_torch.train.trainer import Trainer

NOT_PORTED = ("vqvae", "clvp", "classifier")


def _amp_dtype(cfg: TTTSConfig, device: torch.device) -> Optional[torch.dtype]:
    """bf16 compute on the card when cfg.train.amp, f32 (None) on the CPU."""
    return torch.bfloat16 if cfg.train.amp and device.type == "cuda" else None


def _cadence(cfg: TTTSConfig):
    """(train_steps, save_freq, log_every) in micro-steps: the config states
    them in optimizer updates, so they scale by accumulate_num."""
    m = max(cfg.train.accumulate_num, 1)
    return cfg.train.train_steps * m, cfg.train.save_freq * m, 100 * m


def _simple_batches(dataset, batch_size: int, seed: int, num_workers: int = 4):
    """Shuffled index batches, re-seeded each epoch."""

    def make(epoch: int):
        order = np.random.default_rng(seed + epoch).permutation(len(dataset))
        batches = [list(order[i:i + batch_size])
                   for i in range(0, len(order) - batch_size + 1, batch_size)]
        return DataLoader(dataset, batches, dataset.collate, num_workers=num_workers)

    return EpochLoader(make)


def _bucketed_batches(dataset, batch_size: int, seed: int, boundaries, num_workers: int = 4):
    """Length-bucketed shuffled batches (DistributedBucketSampler over
    `dataset.lengths()`), falling back to _simple_batches when no row lands
    in a bucket."""
    sampler = DistributedBucketSampler(dataset.lengths(), batch_size, list(boundaries),
                                       seed=seed)
    if not sampler.buckets:
        return _simple_batches(dataset, batch_size, seed, num_workers)

    def make(epoch: int):
        sampler.set_epoch(epoch)
        return DataLoader(dataset, list(iter(sampler)), dataset.collate,
                          num_workers=num_workers)

    return EpochLoader(make)


def _build(cls, cfg_part, seed: int, device: torch.device):
    """A model with random weights from `seed`, f32, on `device`."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = cls(cfg_part)
    return model.to(device)


def _adamw(cfg: TTTSConfig, full: bool):
    t = cfg.train
    if full:  # the GPT's chain takes every optimizer knob of the config
        fn = lambda ps: make_adamw(ps, t.lr, t.warmup_steps, t.betas, t.weight_decay,  # noqa: E731
                                   t.grad_clip, t.eps)
    else:  # the JAX package's diffusion chain takes lr and warmup only
        fn = lambda ps: make_adamw(ps, t.lr, t.warmup_steps)  # noqa: E731
    return lambda ps: with_accumulation(fn(ps), t.accumulate_num)


def _trainer(cfg, step, state, data, logs_folder, device) -> Trainer:
    train_steps, save_freq, log_every = _cadence(cfg)
    trainer = Trainer(step, state, data, logs_folder or cfg.train.logs_folder, train_steps,
                      save_freq, cfg.train.keep_ckpts, log_every=log_every,
                      seed=cfg.train.seed, mesh=cfg.mesh, device=device)
    trainer.maybe_resume()
    return trainer


def gpt_trainer(cfg: TTTSConfig, manifest: str, logs_folder: Optional[str] = None,
                device="cuda") -> Trainer:
    """The GPT's Trainer, resumed from its latest checkpoint if any."""
    from ttts_tpu_torch.models.gpt import UnifiedVoice

    device = prepare_device(device)
    ds = GptTtsDataset(manifest)
    # bucketed over VQ-code counts; MAX_CODES = 600, so buckets of 64 up to 640
    data = _bucketed_batches(ds, cfg.train.batch_size, cfg.train.seed,
                             boundaries=range(0, 641, 64))
    model = _build(UnifiedVoice, cfg.gpt, cfg.train.seed, device)
    state = TrainState.create(model, _adamw(cfg, full=True), ema=True)
    step = functools.partial(gpt_train_step, text_weight=cfg.train.text_weight,
                             mel_weight=cfg.train.mel_weight,
                             amp_dtype=_amp_dtype(cfg, device))
    return _trainer(cfg, step, state, data, logs_folder, device)


def train_gpt(cfg: TTTSConfig, manifest: str, logs_folder: Optional[str] = None,
              device="cuda") -> TrainState:
    return gpt_trainer(cfg, manifest, logs_folder, device).train()


def diffusion_trainer(cfg: TTTSConfig, manifest: str, gpt_state_dict: Dict,
                      logs_folder: Optional[str] = None, device="cuda") -> Trainer:
    """The diffusion decoder's Trainer over a frozen GPT with the weights of
    `gpt_state_dict`, resumed from its latest checkpoint if any."""
    from ttts_tpu_torch.diffusion.gaussian import GaussianDiffusion, get_named_beta_schedule
    from ttts_tpu_torch.models.diffusion_net import AA_diffusion
    from ttts_tpu_torch.models.gpt import UnifiedVoice

    device = prepare_device(device)
    gpt_model = UnifiedVoice(cfg.gpt)
    gpt_model.load_state_dict({k: torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v)
                               else v for k, v in gpt_state_dict.items()})
    gpt_model = gpt_model.to(device).eval().requires_grad_(False)
    diffuser = GaussianDiffusion(betas=get_named_beta_schedule(
        cfg.diffusion.noise_schedule, cfg.diffusion.trained_timesteps))
    ds = DiffusionDataset(manifest)
    # bucketed over target-mel frames (capped at MAX_MEL = 400); one worker,
    # so that the dataset's reference-split draws come in order
    data = _bucketed_batches(ds, cfg.train.batch_size, cfg.train.seed,
                             boundaries=range(0, 449, 64), num_workers=1)
    net = _build(AA_diffusion, cfg.diffusion_net, cfg.train.seed, device)
    state = TrainState.create(net, _adamw(cfg, full=False))
    step = functools.partial(diffusion_train_step, diffuser=diffuser, gpt_model=gpt_model,
                             unconditioned_percentage=cfg.train.unconditioned_percentage,
                             amp_dtype=_amp_dtype(cfg, device))
    return _trainer(cfg, step, state, data, logs_folder, device)


def train_diffusion(cfg: TTTSConfig, manifest: str, gpt_state_dict: Dict,
                    logs_folder: Optional[str] = None, device="cuda") -> TrainState:
    return diffusion_trainer(cfg, manifest, gpt_state_dict, logs_folder, device).train()


def load_gpt_state_dict(path: str | pathlib.Path) -> Dict:
    """The GPT weights of a checkpoint directory of this package's training
    (its `ckpt` folder or the logs folder holding it) or of a release
    `.npz`."""
    p = pathlib.Path(path)
    if p.suffix == ".npz":
        return load_state_dict("gpt", p)
    if (p / "ckpt").is_dir():
        p = p / "ckpt"
    _, tree = CheckpointManager(p).restore()
    if tree is None:
        raise FileNotFoundError(f"no checkpoint under {p}")
    return tree["state"]["model"]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("model", choices=["gpt", "diffusion", *NOT_PORTED])
    p.add_argument("--config", default=None)
    p.add_argument("--manifest", default=None)
    p.add_argument("--logs", default=None)
    p.add_argument("--gpt-ckpt", default=None,
                   help="frozen GPT: a checkpoint directory or a release .npz (diffusion)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.model in NOT_PORTED:
        raise NotImplementedError(f"{args.model} training is not ported yet "
                                  "(ROADMAP.md queue 1, item 7)")
    if not args.manifest:
        p.error("--manifest required")
    cfg = load_config(args.config) if args.config else default_config()
    if args.model == "gpt":
        train_gpt(cfg, args.manifest, args.logs, args.device)
    else:
        if not args.gpt_ckpt:
            p.error("--gpt-ckpt required")
        train_diffusion(cfg, args.manifest, load_gpt_state_dict(args.gpt_ckpt), args.logs,
                        args.device)


if __name__ == "__main__":
    main()
