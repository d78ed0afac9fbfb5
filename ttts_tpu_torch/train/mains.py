"""Training entry points of every model, port of ttts_tpu/train/mains.py:

  python -m ttts_tpu_torch.train.mains gpt        --manifest data.jsonl [--config cfg.json]
  python -m ttts_tpu_torch.train.mains diffusion  --manifest data.jsonl --gpt-ckpt logs/ckpt
  python -m ttts_tpu_torch.train.mains vqvae      --manifest wavs.jsonl
  python -m ttts_tpu_torch.train.mains clvp       --manifest data.jsonl
  python -m ttts_tpu_torch.train.mains classifier --clean clean.txt --noise noise.txt

--logs sets the logs folder (checkpoints under <logs>/ckpt, scalars under
<logs>/tb, train.log). --gpt-ckpt is a checkpoint directory of this package's
GPT training or a release `.npz` (export_release). Training runs on the
card unless --device cpu is given; on the card the GPT and diffusion
forwards compute in bf16 under autocast over f32 weights (cfg.train.amp),
as the JAX package's `_amp_dtype` does on an accelerator; so do the CLVP's
x-transformers encoders. The codec GAN and the classifier train in f32, as
JAX's do, with TF32 off. The CLVP trains on `.vq` sidecars (CLVPDataset),
the classifier on lists of clean and noise wavs or directories of their
`.mel` sidecars (PreprocessedMelDataset); its checkpoints feed
`prepare.misc classify`, whose noise_files.txt feeds `prepare.pipeline
filter-noise`.

On N GPUs: `torchrun --nproc_per_node=N -m ttts_tpu_torch.train.mains gpt
...` (or WORLD_SIZE, RANK, MASTER_ADDR and MASTER_PORT set by hand, one
process per GPU; WORLD_SIZE counts processes, where the JAX package's
counts hosts). Each process joins the group (NCCL on the card, gloo with
--device cpu), builds the mesh of cfg.mesh over the processes, loads its
own rank-strided batches of cfg.train.batch_size / (dcn x data ranks) rows
(mains.py:66-100 of the JAX package) and trains data-parallel
(train/steps.py); rank 0 writes the checkpoints and the scalars.
"""

from __future__ import annotations

import argparse
import functools
import pathlib
import wave
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ttts_tpu_torch.config import TTTSConfig, default_config, load_config
from ttts_tpu_torch.data.datasets import (
    CLVPDataset,
    DiffusionDataset,
    GptTtsDataset,
    PreprocessedMelDataset,
    VQGANDataset,
)
from ttts_tpu_torch.data.loader import DataLoader, EpochLoader
from ttts_tpu_torch.data.sampler import DistributedBucketSampler
from ttts_tpu_torch.infer_utils import prepare_device
from ttts_tpu_torch.parallel.mesh import (
    data_axis_size,
    data_rank,
    initialize_distributed,
    make_mesh,
    multihost_requested,
    process_device,
)
from ttts_tpu_torch.train.checkpoints import trained_state_dict
from ttts_tpu_torch.train.state import (
    GanState,
    TrainState,
    make_adamw,
    make_gan_adam,
    with_accumulation,
)
from ttts_tpu_torch.train.steps import (
    classifier_train_step,
    clvp_train_step,
    diffusion_train_step,
    gpt_train_step,
    vqvae_train_step,
)
from ttts_tpu_torch.train.trainer import Trainer


def _amp_dtype(cfg: TTTSConfig, device: torch.device) -> Optional[torch.dtype]:
    """bf16 compute on the card when cfg.train.amp, f32 (None) on the CPU."""
    return torch.bfloat16 if cfg.train.amp and device.type == "cuda" else None


def _cadence(cfg: TTTSConfig):
    """(train_steps, save_freq, log_every) in micro-steps: the config states
    them in optimizer updates, so they scale by accumulate_num."""
    m = max(cfg.train.accumulate_num, 1)
    return cfg.train.train_steps * m, cfg.train.save_freq * m, 100 * m


def _dist_info(device) -> Tuple[int, int]:
    """(rank, world) of this process: when the environment asks for more
    than one process (parallel.multihost_requested), the process group is
    joined first (NCCL for a CUDA device, gloo on the CPU); else (0, 1),
    without one."""
    if multihost_requested():
        return initialize_distributed(device=device)
    return 0, 1


def _setup(cfg: TTTSConfig, device):
    """(device, mesh, data rank, data ranks) of this process: its GPU
    (cuda:LOCAL_RANK) and the mesh of cfg.mesh over the processes in a
    process group; the given device, no mesh and one rank otherwise."""
    _, world = _dist_info(device)
    if world == 1 and not dist.is_initialized():
        return prepare_device(device), None, 0, 1
    device = prepare_device(process_device(device))
    mesh = make_mesh(cfg.mesh)
    return device, mesh, data_rank(mesh), data_axis_size(mesh)


def _per_process_batch(global_batch: int, ranks: int) -> int:
    """The rows each data rank loads of a global batch."""
    if global_batch % ranks:
        raise ValueError(f"global batch {global_batch} must divide over {ranks} data ranks")
    return global_batch // ranks


def _simple_batches(dataset, batch_size: int, seed: int, num_workers: int = 4,
                    num_replicas: int = 1, rank: int = 0):
    """Shuffled index batches, re-seeded each epoch; rank-strided over
    `num_replicas` (every rank draws the same permutation from the shared
    seed and takes batches[rank::num_replicas] of a multiple of them)."""

    def make(epoch: int):
        order = np.random.default_rng(seed + epoch).permutation(len(dataset))
        batches = [list(order[i:i + batch_size])
                   for i in range(0, len(order) - batch_size + 1, batch_size)]
        n = len(batches) // num_replicas * num_replicas
        return DataLoader(dataset, batches[:n][rank::num_replicas], dataset.collate,
                          num_workers=num_workers)

    return EpochLoader(make)


def _bucketed_batches(dataset, batch_size: int, seed: int, boundaries, num_workers: int = 4,
                      num_replicas: int = 1, rank: int = 0):
    """Length-bucketed shuffled batches (DistributedBucketSampler over
    `dataset.lengths()`, this rank's of `num_replicas`), falling back to
    _simple_batches when no row lands in a bucket."""
    sampler = DistributedBucketSampler(dataset.lengths(), batch_size, list(boundaries),
                                       num_replicas=num_replicas, rank=rank, seed=seed)
    if not sampler.buckets:
        return _simple_batches(dataset, batch_size, seed, num_workers, num_replicas, rank)

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


def _trainer(cfg, step, state, data, logs_folder, device, mesh, **hooks) -> Trainer:
    """The Trainer with the config's cadences; `hooks`: eval_fn, eval_freq."""
    train_steps, save_freq, log_every = _cadence(cfg)
    trainer = Trainer(step, state, data, logs_folder or cfg.train.logs_folder, train_steps,
                      save_freq, cfg.train.keep_ckpts, log_every=log_every,
                      seed=cfg.train.seed, mesh=mesh, device=device, **hooks)
    trainer.maybe_resume()
    return trainer


def gpt_trainer(cfg: TTTSConfig, manifest: str, logs_folder: Optional[str] = None,
                device="cuda") -> Trainer:
    """The GPT's Trainer, resumed from its latest checkpoint if any."""
    from ttts_tpu_torch.models.gpt import UnifiedVoice

    device, mesh, rank, ranks = _setup(cfg, device)
    ds = GptTtsDataset(manifest)
    # bucketed over VQ-code counts; MAX_CODES = 600, so buckets of 64 up to 640
    data = _bucketed_batches(ds, _per_process_batch(cfg.train.batch_size, ranks),
                             cfg.train.seed, boundaries=range(0, 641, 64),
                             num_replicas=ranks, rank=rank)
    model = _build(UnifiedVoice, cfg.gpt, cfg.train.seed, device)
    state = TrainState.create(model, _adamw(cfg, full=True), ema=True)
    step = functools.partial(gpt_train_step, text_weight=cfg.train.text_weight,
                             mel_weight=cfg.train.mel_weight,
                             amp_dtype=_amp_dtype(cfg, device))
    return _trainer(cfg, step, state, data, logs_folder, device, mesh)


def train_gpt(cfg: TTTSConfig, manifest: str, logs_folder: Optional[str] = None,
              device="cuda") -> TrainState:
    return gpt_trainer(cfg, manifest, logs_folder, device).train()


def diffusion_trainer(cfg: TTTSConfig, manifest: str, gpt_state_dict: Dict,
                      logs_folder: Optional[str] = None, device="cuda", eval_fn=None,
                      eval_freq: Optional[int] = None) -> Trainer:
    """The diffusion decoder's Trainer over a frozen GPT with the weights of
    `gpt_state_dict`, resumed from its latest checkpoint if any; `eval_fn`
    (e.g. eval_hooks.make_diffusion_eval_fn's) runs every `eval_freq`
    steps (default save_freq)."""
    from ttts_tpu_torch.diffusion.gaussian import GaussianDiffusion, get_named_beta_schedule
    from ttts_tpu_torch.models.diffusion_net import AA_diffusion
    from ttts_tpu_torch.models.gpt import UnifiedVoice

    device, mesh, rank, ranks = _setup(cfg, device)
    gpt_model = UnifiedVoice(cfg.gpt)
    gpt_model.load_state_dict({k: torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v)
                               else v for k, v in gpt_state_dict.items()})
    gpt_model = gpt_model.to(device).eval().requires_grad_(False)
    diffuser = GaussianDiffusion(betas=get_named_beta_schedule(
        cfg.diffusion.noise_schedule, cfg.diffusion.trained_timesteps))
    ds = DiffusionDataset(manifest)
    # bucketed over target-mel frames (capped at MAX_MEL = 400); one worker,
    # so that the dataset's reference-split draws come in order
    data = _bucketed_batches(ds, _per_process_batch(cfg.train.batch_size, ranks),
                             cfg.train.seed, boundaries=range(0, 449, 64), num_workers=1,
                             num_replicas=ranks, rank=rank)
    net = _build(AA_diffusion, cfg.diffusion_net, cfg.train.seed, device)
    state = TrainState.create(net, _adamw(cfg, full=False))
    step = functools.partial(diffusion_train_step, diffuser=diffuser, gpt_model=gpt_model,
                             unconditioned_percentage=cfg.train.unconditioned_percentage,
                             amp_dtype=_amp_dtype(cfg, device))
    return _trainer(cfg, step, state, data, logs_folder, device, mesh, eval_fn=eval_fn,
                    eval_freq=eval_freq)


def train_diffusion(cfg: TTTSConfig, manifest: str, gpt_state_dict: Dict,
                    logs_folder: Optional[str] = None, device="cuda") -> TrainState:
    return diffusion_trainer(cfg, manifest, gpt_state_dict, logs_folder, device).train()


def clvp_trainer(cfg: TTTSConfig, manifest: str, logs_folder: Optional[str] = None,
                 device="cuda") -> Trainer:
    """The CLVP's Trainer (mains.py:187-212): batches bucketed over the
    speech-code counts (buckets of 64 up to 640), AdamW with the config's lr
    and warmup under accumulation, bf16 autocast on the card; resumed from
    its latest checkpoint if any."""
    from ttts_tpu_torch.models.clvp import CLVP

    device, mesh, rank, ranks = _setup(cfg, device)
    ds = CLVPDataset(manifest)
    data = _bucketed_batches(ds, _per_process_batch(cfg.train.batch_size, ranks),
                             cfg.train.seed, boundaries=range(0, 641, 64),
                             num_replicas=ranks, rank=rank)
    model = _build(CLVP, cfg.clvp, cfg.train.seed, device)
    state = TrainState.create(model, _adamw(cfg, full=False))
    step = functools.partial(clvp_train_step, amp_dtype=_amp_dtype(cfg, device))
    return _trainer(cfg, step, state, data, logs_folder, device, mesh)


def train_clvp(cfg: TTTSConfig, manifest: str, logs_folder: Optional[str] = None,
               device="cuda") -> TrainState:
    return clvp_trainer(cfg, manifest, logs_folder, device).train()


def classifier_trainer(cfg: TTTSConfig, clean_list: str, noise_list: str,
                       logs_folder: Optional[str] = None, device="cuda") -> Trainer:
    """The audio-quality classifier's Trainer (mains.py:261-293;
    ttts/classifier/train.py:36-120): shuffled batches of the clean / noise
    mel sidecars cropped to cfg.classifier.pad_to_mel_frames (one loader
    worker, so the crops are drawn in order), AdamW lr 3e-4, betas (0.9,
    0.9999), weight decay 0.01, clip 1.0, no warmup and no accumulation, in
    f32; train_steps and save_freq as the config states them; resumed from
    its latest checkpoint if any."""
    from ttts_tpu_torch.models.classifier import AudioMiniEncoderWithClassifierHead

    device, mesh, rank, ranks = _setup(cfg, device)
    t = cfg.train
    ds = PreprocessedMelDataset(clean_list, noise_list, pad_to=cfg.classifier.pad_to_mel_frames,
                                spec_dim=cfg.classifier.spec_dim,
                                rng=np.random.default_rng(t.seed))
    data = _simple_batches(ds, _per_process_batch(t.batch_size, ranks), t.seed, num_workers=1,
                           num_replicas=ranks, rank=rank)
    model = _build(AudioMiniEncoderWithClassifierHead, cfg.classifier, t.seed, device)
    state = TrainState.create(model, lambda ps: make_adamw(
        ps, 3e-4, warmup_steps=0, betas=(0.9, 0.9999), weight_decay=0.01, grad_clip=1.0))
    trainer = Trainer(classifier_train_step, state, data, logs_folder or t.logs_folder,
                      t.train_steps, t.save_freq, t.keep_ckpts, seed=t.seed, mesh=mesh,
                      device=device)
    trainer.maybe_resume()
    return trainer


def train_classifier(cfg: TTTSConfig, clean_list: str, noise_list: str,
                     logs_folder: Optional[str] = None, device="cuda") -> TrainState:
    return classifier_trainer(cfg, clean_list, noise_list, logs_folder, device).train()


def make_vqvae_augment_cfg(cfg: TTTSConfig):
    from ttts_tpu_torch.data.augment import AugmentConfig

    a, t = cfg.audio, cfg.train
    return AugmentConfig(
        sampling_rate=a.sampling_rate, win_length=a.win_length, hop_length=a.hop_length,
        formant_shift=t.formant_shift, pitch_shift=t.pitch_shift, pitch_range=t.pitch_range,
        q_min=t.q_min, q_max=t.q_max, num_peak=t.num_peak, g_min=t.g_min, g_max=t.g_max)


def make_vqvae_loader(cfg: TTTSConfig, ds: VQGANDataset, num_replicas: int = 1,
                      rank: int = 0) -> EpochLoader:
    """The codec GAN's host data path: a header-only length scan →
    DistributedBucketSampler (0.65-54 s buckets) → the thread-pool
    DataLoader, with the host formant / pitch warp (`wav_warped`) in the
    collate only when cfg.train.aug_warp is on and aug_warp_device off.
    The host warp draws from one generator seeded seed + 17, as JAX's, so
    a resumed run's host warps start over; the device warp draws from the
    step key and resumes exactly. The sampler yields this rank's batches of
    `num_replicas`, each of cfg.train.batch_size / num_replicas rows."""
    from ttts_tpu_torch.data.audio import wav_frames
    from ttts_tpu_torch.data.augment import warp_batch_np

    a = cfg.audio
    lengths = []
    for r in ds.rows:
        try:
            lengths.append(wav_frames(r["path"], target_sr=a.sampling_rate))
        except (OSError, EOFError, wave.Error):
            lengths.append(0)
    aug_cfg = make_vqvae_augment_cfg(cfg)
    warp_rng = np.random.default_rng(cfg.train.seed + 17)

    def collate(items):
        b = ds.collate(items)
        if b is not None and cfg.train.aug_warp and not cfg.train.aug_warp_device:
            b = dict(b, wav_warped=warp_batch_np(warp_rng, b["wav"][..., 0], aug_cfg)[..., None])
        return b

    sampler = DistributedBucketSampler(
        lengths, _per_process_batch(cfg.train.batch_size, num_replicas),
        boundaries=[int(s * a.sampling_rate) for s in (0.65, 2, 4, 8, 16, 32, 54)],
        num_replicas=num_replicas, rank=rank, seed=cfg.train.seed)

    def make(epoch: int):
        sampler.set_epoch(epoch)
        return DataLoader(ds, list(iter(sampler)), collate)

    return EpochLoader(make)


def vqvae_trainer(cfg: TTTSConfig, manifest: str, logs_folder: Optional[str] = None,
                  device="cuda") -> Trainer:
    """The codec GAN's Trainer (a GanState: SynthesizerTrn built for
    training with its codebook waiting for the k-means init, and the
    MultiPeriodDiscriminator, each with make_gan_adam), resumed from its
    latest checkpoint if any. f32 throughout; no accumulation multiplier,
    as in JAX (the reference's codec trainer steps once per batch)."""
    from ttts_tpu_torch.models.discriminator import MultiPeriodDiscriminator
    from ttts_tpu_torch.models.vqvae import SynthesizerTrn

    device, mesh, rank, ranks = _setup(cfg, device)
    a, t = cfg.audio, cfg.train
    ds = VQGANDataset(manifest, sample_rate=a.sampling_rate, hop_length=a.hop_length)
    data = make_vqvae_loader(cfg, ds, ranks, rank)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(t.seed)
        gen = SynthesizerTrn(cfg.vqvae, spec_channels=a.filter_length // 2 + 1,
                             segment_frames=t.segment_size // a.hop_length, for_training=True)
        disc = MultiPeriodDiscriminator()
    gen, disc = gen.to(device), disc.to(device)
    gan = lambda ps: make_gan_adam(ps, t.lr, decay=t.lr_decay)  # noqa: E731
    state = GanState(TrainState.create(gen, gan), TrainState.create(disc, gan))
    aug_cfg = make_vqvae_augment_cfg(cfg)
    step = functools.partial(vqvae_train_step, audio_cfg=a, c_mel=t.c_mel, c_kl=t.c_kl,
                             augment_cfg=aug_cfg,
                             device_warp=t.aug_warp and t.aug_warp_device)
    trainer = Trainer(step, state, data, logs_folder or t.logs_folder, t.train_steps,
                      t.save_freq, t.keep_ckpts, seed=t.seed, mesh=mesh, device=device)
    trainer.maybe_resume()
    return trainer


def train_vqvae(cfg: TTTSConfig, manifest: str, logs_folder: Optional[str] = None,
                device="cuda") -> GanState:
    return vqvae_trainer(cfg, manifest, logs_folder, device).train()


def load_gpt_state_dict(path: str | pathlib.Path) -> Dict:
    """The GPT weights of a checkpoint directory of this package's training
    (its `ckpt` folder or the logs folder holding it) or of a release
    `.npz`."""
    return trained_state_dict("gpt", path)[0]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("model", choices=["gpt", "diffusion", "vqvae", "clvp", "classifier"])
    p.add_argument("--config", default=None)
    p.add_argument("--manifest", default=None)
    p.add_argument("--logs", default=None)
    p.add_argument("--gpt-ckpt", default=None,
                   help="frozen GPT: a checkpoint directory or a release .npz (diffusion)")
    p.add_argument("--clean", default=None, help="clean wav/dir list file (classifier)")
    p.add_argument("--noise", default=None, help="noise wav/dir list file (classifier)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.model == "classifier":
        if not (args.clean and args.noise):
            p.error("--clean and --noise required")
    elif not args.manifest:
        p.error("--manifest required")
    cfg = load_config(args.config) if args.config else default_config()
    if args.model == "classifier":
        train_classifier(cfg, args.clean, args.noise, args.logs, args.device)
    elif args.model == "gpt":
        train_gpt(cfg, args.manifest, args.logs, args.device)
    elif args.model == "clvp":
        train_clvp(cfg, args.manifest, args.logs, args.device)
    elif args.model == "vqvae":
        train_vqvae(cfg, args.manifest, args.logs, args.device)
    else:
        if not args.gpt_ckpt:
            p.error("--gpt-ckpt required")
        train_diffusion(cfg, args.manifest, load_gpt_state_dict(args.gpt_ckpt), args.logs,
                        args.device)


if __name__ == "__main__":
    main()
