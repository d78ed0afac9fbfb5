"""Train steps of the GPT and the diffusion decoder, port of
ttts_tpu/train/steps.py:42-149.

  - GPT: loss = 0.01 * text CE + 1.0 * mel CE (ttts/gpt/train.py:89-136).
  - Diffusion: the frozen GPT's latent (no grad, eval mode: on the card its
    attention is the causal flash kernel), x_start = the normalised mel,
    uniform timesteps, MSE + VLB (ttts/diffusion/train.py:146-202).

A step is (state, batch, key) → metrics, with `state` a TrainState updated
in place and `key` an integer seed. Every draw of a step comes from the
key: t, the noise, the unconditioned rows and the layer-drop choices from
explicit torch.Generators (`diffusion_draws`; tests inject the JAX
package's draws instead), dropout from the global generators reseeded
inside the step (torch.random.fork_rng), so a step repeats exactly given
its key. `amp_dtype` (bf16 on the card) runs the forward under autocast
over the f32 weights. The VQ-VAE GAN, CLVP and classifier steps are not
ported yet.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch

from ttts_tpu_torch.models.diffusion_net import normalize_tacotron_mel
from ttts_tpu_torch.train.state import TrainState, ema_update, global_norm


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
    return torch.autograd.grad(loss, params, allow_unused=True)


# --------------------------------------------------------------------- GPT


def gpt_loss(model, batch: Dict[str, torch.Tensor], text_weight: float = 0.01,
             mel_weight: float = 1.0):
    """(weighted loss, text CE, mel CE) of the training forward."""
    lt, lm, _ = model(batch["text"], batch["text_lengths"], batch["mel_codes"],
                      batch["wav_lengths"], return_latent=False)
    return text_weight * lt + mel_weight * lm, lt, lm


def gpt_train_step(state: TrainState, batch, key: int, text_weight: float = 0.01,
                   mel_weight: float = 1.0, amp_dtype: Optional[torch.dtype] = None):
    """batch: text (B, Lt), text_lengths, mel_codes (B, Lm), wav_lengths."""
    model = state.model.train()
    dev = _device(model)
    with seeded(key, dev), autocast(dev, amp_dtype):
        loss, lt, lm = gpt_loss(model, batch, text_weight, mel_weight)
    norm, finite, fired = apply_gradients_safe(state, _grads(loss, state.params))
    if state.ema is not None and finite and fired:
        # only when an update was applied: under accumulation, decaying on
        # every micro-step would compound the decay
        ema_update(state.ema, state.params)
    return {"loss": loss.detach(), "loss_text": lt.detach(), "loss_mel": lm.detach(),
            "grad_norm": norm, "nonfinite_skipped": 0.0 if finite else 1.0}


# ---------------------------------------------------------------- diffusion


def diffusion_draws(key: int, x_shape, num_timesteps: int, num_layers: int,
                    unconditioned_percentage: float, layer_drop: float,
                    device: torch.device) -> Dict:
    """A step's draws from `key`: t (B,) uniform, noise of x's shape, the
    unconditioned rows (B,) bool and one keep per trunk layer. The small
    draws come from a CPU generator (the layer choices steer the host), the
    noise from one on `device`."""
    g = torch.Generator().manual_seed(key % (2 ** 63))
    b = x_shape[0]
    t = torch.randint(0, num_timesteps, (b,), generator=g)
    uncond = torch.rand(b, generator=g) < unconditioned_percentage
    keep = (torch.rand(num_layers, generator=g) >= layer_drop).tolist()
    noise_seed = int(torch.randint(2 ** 62, (1,), generator=g))
    gd = torch.Generator(device).manual_seed(noise_seed)
    noise = torch.randn(tuple(x_shape), generator=gd, device=device)
    return {"t": t.to(device), "noise": noise, "uncond": uncond.to(device),
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
                         amp_dtype: Optional[torch.dtype] = None, draws=None):
    """batch: text, text_lengths, mel (B, T, 100), mel_refer (B, Tr, 100),
    mel_codes, wav_lengths. `draws` (diffusion_draws' keys) replaces the
    key's draws of t, noise, the unconditioned rows and the layer choices."""
    net = state.model.train()
    dev = _device(net)
    latent = frozen_latent(gpt_model, batch, amp_dtype)
    if draws is None:
        draws = diffusion_draws(key, batch["mel"].shape, diffuser.num_timesteps,
                                len(net.layers), unconditioned_percentage,
                                net.cfg.layer_drop, dev)
    with seeded(key, dev), autocast(dev, amp_dtype):
        loss, mse, vb = diffusion_loss(net, diffuser, batch, latent, draws)
    norm, finite, _ = apply_gradients_safe(state, _grads(loss, state.params))
    return {"loss": loss.detach(), "mse": mse.detach(), "vb": vb.detach(),
            "grad_norm": norm, "nonfinite_skipped": 0.0 if finite else 1.0}
