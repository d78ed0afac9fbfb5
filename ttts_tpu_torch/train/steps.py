"""Train steps of every model family, port of ttts_tpu/train/steps.py.

  - GPT: loss = 0.01 * text CE + 1.0 * mel CE (ttts/gpt/train.py:89-136).
  - Diffusion: the frozen GPT's latent (no grad, eval mode: on the card its
    attention is the causal flash kernel), x_start = the normalised mel,
    uniform timesteps, MSE + VLB (ttts/diffusion/train.py:146-202).
  - VQ-VAE GAN (ttts/vqvae/train.py:313-459): the device formant / pitch
    warp and the parametric EQ, the linear spectrograms, ONE generator
    forward (its quantizer searches through the VQ kernel on the card and
    updates the EMA / k-means codebook), the discriminator step on the
    detached fake, then the generator step (mel L1 x 45, KL x 1, feature
    matching, adversarial, commit) through the *updated* discriminator; in
    f32, without a non-finite skip, as JAX's step.
  - CLVP (ttts/clvp/train.py; steps.py:301-314): the symmetric InfoNCE of
    the training forward (mask draws, dropout), applied with the
    non-finite skip.
  - Classifier (ttts/classifier/train.py; steps.py:317-326): the cross
    entropy of the training forward (dropout), a plain update without a
    skip, as JAX's.

A step is (state, batch, key, mesh=None) → metrics, with `state` a
TrainState updated in place and `key` an integer seed. Every draw of a step comes from the
key: t, the noise, the unconditioned rows and the layer-drop choices from
explicit torch.Generators (`diffusion_draws`, `vqvae_draws`, `clvp_draws`;
tests inject the JAX package's draws instead), dropout from the global
generators reseeded inside the step (torch.random.fork_rng), so a step
repeats exactly given its key. `amp_dtype` (bf16 on the card) runs the GPT,
diffusion and CLVP forwards under autocast over the f32 weights; the
classifier trains in f32, as JAX's (its model has no dtype).

Data parallel (`mesh`, parallel.make_mesh's, with a data and maybe a dcn
axis; the JAX package's batch-sharded steps): the batch is this rank's rows
of the global batch. The draws are the global batch's from the key and each
rank takes its rows (`*_draws(..., mesh)`; an injected `draws` is this
rank's); the gradients, with the step's metrics, are averaged over the
batch ranks in one coalesced all-reduce per optimizer, before the
non-finite skip, the clip and the update, so that skip, clip, AdamW and
EMA agree on every rank; a loss that is global over the batch is computed
as such (the CLVP's InfoNCE over the gathered latents, the KL's mask count,
the codebook's statistics). Dropout draws from the key offset by the data
rank (rank 0's stream is the single process's), so a step with dropout
matches the single process in distribution only.

Spans (utils.logging.span, seen only while a profiler records): a step's
single loss computation is `ttts.train.forward`, every `_grads` is
`ttts.train.backward`, and every optimizer update (with the non-finite
check and the clip of `apply_gradients_safe`, and the EMA) is
`ttts.train.update`.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch

from ttts_tpu_torch.data.augment import apply_peq, sample_params, warp_batch_device, warp_draws
from ttts_tpu_torch.models.diffusion_net import normalize_tacotron_mel
from ttts_tpu_torch.models.losses import (
    discriminator_loss,
    feature_loss,
    generator_loss,
    kl_loss,
)
from ttts_tpu_torch.models.quantize import vq_draws
from ttts_tpu_torch.models.vqvae import slice_segments
from ttts_tpu_torch.ops.mel import vits_mel_spectrogram, vits_spectrogram
from ttts_tpu_torch.parallel.mesh import (
    all_reduce,
    batch_groups,
    data_axis_size,
    data_rank,
    shard_batch,
)
from ttts_tpu_torch.train.state import GanState, TrainState, ema_update, global_norm
from ttts_tpu_torch.utils.logging import span


optax_global_norm = global_norm  # the JAX package's name


def apply_gradients_safe(state: TrainState, grads) -> Tuple[torch.Tensor, bool, bool]:
    """Apply `grads` only when their global norm is finite (steps.py:90-106):
    a non-finite micro-step leaves the parameters, the optimizer's moments
    and accumulator, and state.step as they were. Returns (norm, finite,
    fired), fired True when the optimizer applied an update."""
    norm = optax_global_norm(grads)
    if not bool(torch.isfinite(norm)):
        return norm, False, False
    fired = state.opt.update(grads, norm)
    state.step += 1
    return norm, True, fired


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


@contextlib.contextmanager
def seeded(key: int, device: torch.device):
    """The global generators of the CPU and `device` seeded from `key` (the
    dropout draws), restored on exit."""
    devices = [device] if device.type == "cuda" else []
    with torch.random.fork_rng(devices=devices):
        torch.manual_seed(key % (2 ** 63))
        yield


def autocast(device: torch.device, amp_dtype: Optional[torch.dtype]):
    if amp_dtype is None or amp_dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(device.type, dtype=amp_dtype)


def _grads(loss: torch.Tensor, params: List[torch.Tensor]):
    with span("ttts.train.backward"):
        return torch.autograd.grad(loss, params, allow_unused=True)


def _dropout_key(key: int, mesh) -> int:
    """The dropout seed of this data rank (rank 0's is the key)."""
    return key if mesh is None else key + data_rank(mesh)


def _ranks(mesh) -> int:
    return 1 if mesh is None else data_axis_size(mesh)


def _rows(x, mesh):
    """This rank's rows of a global batch's draw (a tensor or a dict of
    them); all of it without a mesh."""
    if mesh is None:
        return x
    if isinstance(x, dict):
        return {k: _rows(v, mesh) for k, v in x.items()}
    return shard_batch(mesh, x)


def _mean_over_ranks(mesh, grads, *metrics):
    """(grads, metrics) averaged over the batch ranks in one all-reduce;
    as they are without a mesh (the metrics detached)."""
    out = all_reduce(list(grads) + [m.detach() for m in metrics], batch_groups(mesh))
    return out[:len(grads)], out[len(grads):]


# --------------------------------------------------------------------- GPT


def gpt_loss(model, batch: Dict[str, torch.Tensor], text_weight: float = 0.01,
             mel_weight: float = 1.0):
    """(weighted loss, text CE, mel CE) of the training forward."""
    lt, lm, _ = model(batch["text"], batch["text_lengths"], batch["mel_codes"],
                      batch["wav_lengths"], return_latent=False)
    return text_weight * lt + mel_weight * lm, lt, lm


def gpt_train_step(state: TrainState, batch, key: int, text_weight: float = 0.01,
                   mel_weight: float = 1.0, amp_dtype: Optional[torch.dtype] = None,
                   mesh=None):
    """batch: text (B, Lt), text_lengths, mel_codes (B, Lm), wav_lengths."""
    model = state.model.train()
    dev = _device(model)
    with span("ttts.train.forward"), seeded(_dropout_key(key, mesh), dev), \
            autocast(dev, amp_dtype):
        loss, lt, lm = gpt_loss(model, batch, text_weight, mel_weight)
    grads, (loss, lt, lm) = _mean_over_ranks(mesh, _grads(loss, state.params), loss, lt, lm)
    with span("ttts.train.update"):
        norm, finite, fired = apply_gradients_safe(state, grads)
        if state.ema is not None and finite and fired:
            # only when an update was applied: under accumulation, decaying on
            # every micro-step would compound the decay
            ema_update(state.ema, state.params)
    return {"loss": loss, "loss_text": lt, "loss_mel": lm,
            "grad_norm": norm, "nonfinite_skipped": 0.0 if finite else 1.0}


# ---------------------------------------------------------------- diffusion


def diffusion_draws(key: int, x_shape, num_timesteps: int, num_layers: int,
                    unconditioned_percentage: float, layer_drop: float,
                    device: torch.device, mesh=None) -> Dict:
    """A step's draws from `key`: t (B,) uniform, noise of x's shape, the
    unconditioned rows (B,) bool and one keep per trunk layer. The small
    draws come from a CPU generator (the layer choices steer the host), the
    noise from one on `device`. `mesh`: x_shape is this rank's; the draws
    are the global batch's rows of this rank."""
    g = torch.Generator().manual_seed(key % (2 ** 63))
    x_shape = (x_shape[0] * _ranks(mesh),) + tuple(x_shape[1:])
    b = x_shape[0]
    t = torch.randint(0, num_timesteps, (b,), generator=g)
    uncond = torch.rand(b, generator=g) < unconditioned_percentage
    keep = (torch.rand(num_layers, generator=g) >= layer_drop).tolist()
    noise_seed = int(torch.randint(2 ** 62, (1,), generator=g))
    gd = torch.Generator(device).manual_seed(noise_seed)
    noise = torch.randn(tuple(x_shape), generator=gd, device=device)
    return {**_rows({"t": t.to(device), "noise": noise, "uncond": uncond.to(device)}, mesh),
            "layer_keep": keep}


@torch.no_grad()
def frozen_latent(gpt_model, batch, amp_dtype: Optional[torch.dtype] = None):
    """The frozen GPT's conditioning latent (B, T, D) f32, in eval mode and
    without grad (on the card at bf16: the causal attention kernel)."""
    gpt_model.eval()
    with autocast(_device(gpt_model), amp_dtype):
        latent = gpt_model(batch["text"], batch["text_lengths"], batch["mel_codes"],
                           batch["wav_lengths"], return_latent=True)
    return latent.float()


def diffusion_loss(net, diffuser, batch, latent, draws):
    """(mean loss, mean MSE, mean VLB) of the denoiser on `draws`."""
    x_start = normalize_tacotron_mel(batch["mel"])
    refer = normalize_tacotron_mel(batch["mel_refer"])

    def model_fn(x, t_in, conditioning_free=False):
        return net(x, t_in, latent, refer, conditioning_free=conditioning_free,
                   uncond=draws["uncond"], layer_keep=draws["layer_keep"])

    losses = diffuser.training_losses(model_fn, x_start, draws["t"], draws["noise"])
    return losses["loss"].mean(), losses["mse"].mean(), losses["vb"].mean()


def diffusion_train_step(state: TrainState, batch, key: int, diffuser, gpt_model,
                         unconditioned_percentage: float = 0.1,
                         amp_dtype: Optional[torch.dtype] = None, draws=None, mesh=None):
    """batch: text, text_lengths, mel (B, T, 100), mel_refer (B, Tr, 100),
    mel_codes, wav_lengths. `draws` (diffusion_draws' keys) replaces the
    key's draws of t, noise, the unconditioned rows and the layer choices."""
    net = state.model.train()
    dev = _device(net)
    latent = frozen_latent(gpt_model, batch, amp_dtype)
    if draws is None:
        draws = diffusion_draws(key, batch["mel"].shape, diffuser.num_timesteps,
                                len(net.layers), unconditioned_percentage,
                                net.cfg.layer_drop, dev, mesh)
    with span("ttts.train.forward"), seeded(_dropout_key(key, mesh), dev), \
            autocast(dev, amp_dtype):
        loss, mse, vb = diffusion_loss(net, diffuser, batch, latent, draws)
    grads, (loss, mse, vb) = _mean_over_ranks(mesh, _grads(loss, state.params), loss, mse, vb)
    with span("ttts.train.update"):
        norm, finite, _ = apply_gradients_safe(state, grads)
    return {"loss": loss, "mse": mse, "vb": vb,
            "grad_norm": norm, "nonfinite_skipped": 0.0 if finite else 1.0}


# ------------------------------------------------------------------- VQ-VAE


def vqvae_draws(key: int, batch, model, hop_length: int, augment_cfg=None,
                device_warp: bool = False, mesh=None) -> Dict:
    """A GAN step's draws from `key`: enc_q's noise (B, T, inter_channels)
    on the batch's device, the slice starts `ids_slice` (B,) = floor(u *
    (max(len - segment_frames, 0) + 1)), the quantizer's k-means and expiry
    rows (`vq`, quantize.vq_draws over B * T/2 rows), and with `augment_cfg`
    the EQ's parameters (`peq`, augment.sample_params) and, with
    `device_warp`, the warp's factors (`warp`, augment.warp_draws). T =
    wav samples / hop_length; `model` the SynthesizerTrn. `mesh`: the batch
    is this rank's; the per-row draws are the global batch's rows of this
    rank, `vq` the global batch's (the quantizer draws from the global
    pool)."""
    g = torch.Generator().manual_seed(key % (2 ** 63))
    wav, dev = batch["wav"], batch["wav"].device
    b, frames = wav.shape[0] * _ranks(mesh), wav.shape[1] // hop_length
    c = model.cfg
    u = _rows(torch.rand(b, generator=g), mesh)
    lengths = batch["spec_lengths"].cpu()
    out = {"ids_slice": (u * ((lengths - model.segment_frames).clamp_min(0) + 1)).long(),
           "vq": vq_draws(b * (frames // 2), c.n_q, c.codebook_bins, c.kmeans_seeding, g)}
    if augment_cfg is not None:
        out["peq"] = _rows(sample_params(g, b, augment_cfg), mesh)
        if device_warp:
            out["warp"] = _rows(warp_draws(g, b, augment_cfg), mesh)
    noise_seed = int(torch.randint(2 ** 62, (1,), generator=g))
    gd = torch.Generator(dev).manual_seed(noise_seed)
    out["noise"] = _rows(torch.randn((b, frames, c.inter_channels), generator=gd, device=dev),
                         mesh)
    return out


def _spec(wav: torch.Tensor, a) -> torch.Tensor:
    """(B, T*hop, 1) → the linear spectrogram (B, T, filter_length//2 + 1)."""
    return vits_spectrogram(wav[..., 0], a.filter_length, a.hop_length,
                            a.win_length).transpose(1, 2)


@torch.no_grad()
def vqvae_inputs(batch, audio_cfg, draws, augment_cfg=None, device_warp: bool = False):
    """The GAN step's inputs (steps.py:181-216): wav_aug (the host warp's
    `wav_warped`, or the device warp when `device_warp`, or wav; then the
    EQ when `augment_cfg`), spec and spec_aug, unless the batch holds them."""
    batch = dict(batch)
    if "wav_aug" not in batch:
        base = batch.pop("wav_warped", None)
        if base is None:
            base = batch["wav"]
            if device_warp and augment_cfg is not None:
                base = warp_batch_device(base[..., 0], draws["warp"], augment_cfg)[..., None]
        if augment_cfg is not None:
            p = draws["peq"]
            base = apply_peq(base[..., 0], p["quality_power"], p["gain"], augment_cfg)[..., None]
        batch["wav_aug"] = base
    for k, w in (("spec", "wav"), ("spec_aug", "wav_aug")):
        if k not in batch:
            batch[k] = _spec(batch[w], audio_cfg)
    return batch


def _mel(wav: torch.Tensor, a) -> torch.Tensor:
    return vits_mel_spectrogram(wav[..., 0], a.filter_length, a.n_mel_channels,
                                a.sampling_rate, a.hop_length, a.win_length, a.mel_fmin,
                                a.mel_fmax)


def vqvae_train_step(state: GanState, batch, key: int, audio_cfg, c_mel: float = 45.0,
                     c_kl: float = 1.0, augment_cfg=None, device_warp: bool = False,
                     draws=None, mesh=None):
    """One alternating D / G step (vqvae/train.py:313-406) on state.g (the
    SynthesizerTrn built for training) and state.d (the MPD), both updated
    in place. batch: wav (B, T*hop, 1), spec_lengths, text, text_lengths
    (+ optionally wav_warped, or wav_aug / spec / spec_aug). `draws`
    (vqvae_draws' keys) replaces the key's draws. → the seven losses."""
    gen, disc = state.g.model.train(), state.d.model.train()
    dev = _device(gen)
    a, hop, seg = audio_cfg, audio_cfg.hop_length, gen.segment_frames
    if draws is None:
        draws = vqvae_draws(key, batch, gen, hop, augment_cfg, device_warp, mesh)
    batch = vqvae_inputs(batch, a, draws, augment_cfg, device_warp)
    # one generator forward, shared by the D and G steps
    with seeded(_dropout_key(key, mesh), dev):
        y_hat, commit, ids_slice, y_mask, stats, _ = gen(
            batch["wav"], batch["wav_aug"], batch["spec"], batch["spec_aug"],
            batch["spec_lengths"], batch["text"], batch["text_lengths"],
            noise=draws["noise"], ids_slice=draws["ids_slice"], vq_draws=draws["vq"],
            mesh=mesh)
    y_real = slice_segments(batch["wav"], ids_slice * hop, seg * hop)
    # discriminator step, the fake detached
    yr, yg, _, _ = disc(y_real, y_hat.detach())
    loss_disc, _, _ = discriminator_loss(yr, yg)
    grads, (loss_disc,) = _mean_over_ranks(mesh, _grads(loss_disc, state.d.params), loss_disc)
    with span("ttts.train.update"):
        state.d.opt.update(grads)
    state.d.step += 1
    # generator step through the updated discriminator; the gradients of
    # G's parameters only (D gathers none from this loss)
    z, z_p, m_p, logs_p, m_q, logs_q = stats
    with torch.no_grad():
        mel_real = _mel(y_real, a)
    _, yg, fr, fg = disc(y_real, y_hat)
    loss_mel = torch.mean(torch.abs(mel_real - _mel(y_hat, a))) * c_mel
    # the KL is a ratio of sums over the batch: the ranks' mean mask count
    mask_sum = None if mesh is None else all_reduce([y_mask.sum()], batch_groups(mesh))[0]
    loss_kl = kl_loss(z_p, logs_q, m_p, logs_p, y_mask, mask_sum) * c_kl
    loss_fm = feature_loss(fr, fg)
    loss_adv, _ = generator_loss(yg)
    loss_gen_all = loss_mel + loss_kl + loss_fm + loss_adv + commit
    grads, metrics = _mean_over_ranks(mesh, _grads(loss_gen_all, state.g.params), loss_gen_all,
                                      loss_mel, loss_kl, loss_fm, loss_adv, commit)
    with span("ttts.train.update"):
        state.g.opt.update(grads)
    state.g.step += 1
    return dict(zip(("loss_disc", "loss_gen_all", "loss_mel", "loss_kl", "loss_fm",
                     "loss_adv", "commit_loss"), [loss_disc] + metrics))


# --------------------------------------------------------------------- CLVP


def clvp_draws(key: int, cfg, text_shape, speech_shape, device: torch.device,
               mesh=None) -> Dict:
    """A CLVP step's mask draws from `key`: uniforms of the text's and the
    speech codes' shapes, each only where its mask percentage is above 0.
    `mesh`: the shapes are this rank's; the draws are the global batch's
    rows of this rank."""
    g = torch.Generator().manual_seed(key % (2 ** 63))
    n = _ranks(mesh)
    out = {}
    if cfg.text_mask_percentage > 0:
        out["text"] = torch.rand((text_shape[0] * n,) + tuple(text_shape[1:]),
                                 generator=g).to(device)
    if cfg.voice_mask_percentage > 0:
        out["voice"] = torch.rand((speech_shape[0] * n,) + tuple(speech_shape[1:]),
                                  generator=g).to(device)
    return _rows(out, mesh)


def clvp_loss(model, batch, draws=None, mesh=None) -> torch.Tensor:
    """The training forward's symmetric InfoNCE (f32); `mesh`: over the
    global batch (CLVP.forward)."""
    return model(batch["text"], batch["speech_tokens"], return_loss=True, mask_draws=draws,
                 mesh=mesh)


def clvp_train_step(state: TrainState, batch, key: int,
                    amp_dtype: Optional[torch.dtype] = None, draws=None, mesh=None):
    """batch: text (B, Lt), speech_tokens (B, Ls). `draws` (clvp_draws'
    keys) replaces the key's mask draws."""
    model = state.model.train()
    dev = _device(model)
    if draws is None:
        draws = clvp_draws(key, model.cfg, batch["text"].shape, batch["speech_tokens"].shape,
                           dev, mesh)
    with span("ttts.train.forward"), seeded(_dropout_key(key, mesh), dev), \
            autocast(dev, amp_dtype):
        loss = clvp_loss(model, batch, draws, mesh)
    grads, (loss,) = _mean_over_ranks(mesh, _grads(loss, state.params), loss)
    with span("ttts.train.update"):
        norm, finite, _ = apply_gradients_safe(state, grads)
    return {"loss": loss, "grad_norm": norm,
            "nonfinite_skipped": 0.0 if finite else 1.0}


# --------------------------------------------------------------- classifier


def classifier_train_step(state: TrainState, batch, key: int, mesh=None):
    """batch: mel (B, T, spec_dim), labels (B,). One update, whatever the
    gradients hold (no non-finite skip, as JAX's step)."""
    model = state.model.train()
    with span("ttts.train.forward"), seeded(_dropout_key(key, mesh), _device(model)):
        loss = model(batch["mel"], labels=batch["labels"])
    grads, (loss,) = _mean_over_ranks(mesh, _grads(loss, state.params), loss)
    with span("ttts.train.update"):
        state.opt.update(grads)
    state.step += 1
    return {"loss": loss}
