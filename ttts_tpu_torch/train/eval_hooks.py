"""In-training evaluation hooks, port of ttts_tpu/train/eval_hooks.py: the
Trainer calls `eval_fn(step, state, writer)` every eval_freq steps.

  - diffusion (ttts/diffusion/train.py:213-247): cond-free DPM++(2M)
    sampling on the first row of a held-out batch with the trained
    denoiser's current weights (not the EMA shadow, as in JAX), decoded by
    Vocos; the writer gets the generated and target mels (n_mels, T) and
    the waveform;
  - vqvae (ttts/vqvae/train.py:408-459): the loss mels of the latest real
    and generated slices, and both slices as audio.

The JAX hooks hand the writer matplotlib images of the mels
(plot_spectrogram_to_numpy); the port hands it the mel arrays themselves
(utils/logging.py).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ttts_tpu_torch.utils.logging import SummaryWriter


def make_diffusion_eval_fn(net, gpt_model, vocos_model, eval_batch: Dict[str, np.ndarray],
                           steps: int = 50, guidance_scale: float = 2.0,
                           sample_rate: int = 24000,
                           amp_dtype: Optional[torch.dtype] = None):
    """→ eval_fn(step, state, writer, noise=None) → (mel (1, T, n_mels),
    waveform (1, L)). `net` is the AA_diffusion that samples: each call
    loads the weights of state.model into it. With `amp_dtype` (bf16 on the
    card) its matmul weights are stored in that dtype, as serving stores
    them (api.cast_for_inference), and the frozen GPT's latent runs under
    autocast, as in the diffusion train step; the hook runs without grad,
    so the trunk's bias-attention and resblock kernels and the GPT's causal
    kernel launch on the card. The start noise (1, T, n_mels) is drawn from
    a generator seeded with `step` unless given. `eval_batch` holds the
    diffusion collate's keys; its first row is sampled."""
    from ttts_tpu_torch.api import cast_for_inference
    from ttts_tpu_torch.diffusion.dpm import cfg_eps_fn, dpm_solver_pp_2m_sample
    from ttts_tpu_torch.models.diffusion_net import (
        denormalize_tacotron_mel,
        normalize_tacotron_mel,
    )
    from ttts_tpu_torch.train.steps import frozen_latent

    dev = next(gpt_model.parameters()).device
    net = net.to(dev).eval().requires_grad_(False)
    if amp_dtype is not None:
        cast_for_inference(net, amp_dtype)
    vocos_model = vocos_model.to(dev).eval().requires_grad_(False)
    batch = {k: torch.as_tensor(np.asarray(v)[:1]) for k, v in eval_batch.items()}
    batch = {k: (v if v.is_floating_point() else v.long()).to(dev) for k, v in batch.items()}

    @torch.no_grad()
    def eval_fn(step: int, state, writer: Optional[SummaryWriter],
                noise: Optional[torch.Tensor] = None):
        net.load_state_dict(state.model.state_dict())
        latent = frozen_latent(gpt_model, batch, amp_dtype)
        out_len = batch["mel"].shape[1]
        cond = net.timestep_independent(latent, normalize_tacotron_mel(batch["mel_refer"]),
                                        out_len)
        biases = net.rel_biases(out_len)
        eps_fn = cfg_eps_fn(lambda x2, t2, e2: net.trunk(x2, t2, e2, biases), cond,
                            net.unconditioned(1, out_len), guidance_scale)
        if noise is None:
            g = torch.Generator(dev).manual_seed(int(step))
            noise = torch.randn((1, out_len, batch["mel"].shape[-1]), generator=g, device=dev)
        mel = denormalize_tacotron_mel(dpm_solver_pp_2m_sample(eps_fn, noise.to(dev),
                                                               steps=steps))
        wav = vocos_model(mel)
        if writer is not None:
            writer.summarize(
                step,
                images={"eval/mel_generated": mel[0].T.cpu().numpy(),
                        "eval/mel_target": batch["mel"][0].T.cpu().numpy()},
                audios={"eval/sample": wav[0].float().cpu().numpy()},
                audio_sampling_rate=sample_rate)
        return mel, wav

    return eval_fn


def make_vqvae_eval_fn(audio_cfg, sample_rate: int = 32000):
    """→ eval_fn(step, state, writer, y_real=None, y_hat=None): the loss
    mels (n_mels, frames) of the first real and generated slice (B, L, 1)
    and both slices as audio; nothing without the slices. Returns the two
    mels (B, n_mels, frames), or None."""
    from ttts_tpu_torch.ops.mel import vits_mel_spectrogram

    a = audio_cfg

    @torch.no_grad()
    def eval_fn(step: int, state, writer: Optional[SummaryWriter], y_real=None, y_hat=None):
        if y_real is None or y_hat is None:
            return None
        mels = [vits_mel_spectrogram(torch.as_tensor(y)[..., 0].float(), a.filter_length,
                                     a.n_mel_channels, a.sampling_rate, a.hop_length,
                                     a.win_length) for y in (y_real, y_hat)]
        if writer is not None:
            writer.summarize(
                step,
                images={"eval/slice_mel_real": mels[0][0].cpu().numpy(),
                        "eval/slice_mel_gen": mels[1][0].cpu().numpy()},
                audios={"eval/slice_real": np.asarray(torch.as_tensor(y_real)[0, :, 0].cpu()),
                        "eval/slice_gen": np.asarray(torch.as_tensor(y_hat)[0, :, 0].cpu())},
                audio_sampling_rate=sample_rate)
        return mels

    return eval_fn
