"""Train state and optimizer, port of ttts_tpu/train/state.py.

`AdamW` is the JAX package's optimizer chain, held to optax's arithmetic
(tests/test_torch_train_state.py compares them on injected gradients):

- optax.clip_by_global_norm: the grads scale by max / norm only when
  norm >= max (torch's clip_grad_norm_ scales by max / (norm + 1e-6));
- optax.adamw with the warmup schedule lr * min(1, (count + 1) / warmup),
  indexed by the updates applied so far, weight decay on every parameter
  (update = adam + wd * p, then p += -lr_t * update);
- optax.MultiSteps(k) when accumulate_num > 1 (`MultiSteps`): the
  running mean of k micro-step grads, then one clip and update; in between
  the parameters stay put.

Gradients of parameters that took no part in the loss (None) count as
zeros, as JAX's gradients of an unused parameter are. `ema_update` is the
shadow-weight EMA. `make_gan_adam` is the codec GAN's optax.adamw (betas
(0.8, 0.99), eps 1e-9, weight decay 0.01, lr * decay^count, no clip), and
`GanState` the paired generator / discriminator state its trainer holds.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn


def warmup_constant_schedule(lr: float, warmup_steps: int) -> Callable[[int], np.float32]:
    """count → lr * min(1, (count + 1) / warmup) in float32 (gpt/train.py:36)."""
    w = np.float32(max(warmup_steps, 1))

    def fn(count: int) -> np.float32:
        return np.float32(lr) * np.minimum(np.float32(1.0), np.float32(count + 1) / w)

    return fn


def exponential_decay_schedule(lr: float, decay: float) -> Callable[[int], np.float32]:
    """count → lr * decay^count in float32 (the vqvae ExponentialLR, applied
    per update with a gentler decay, as the JAX package applies it)."""

    def fn(count: int) -> np.float32:
        return np.float32(lr) * np.float32(decay) ** np.float32(count)

    return fn


def global_norm(tensors: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
    """The norm of the per-tensor norms (None counts as zero), in f32: the
    sqrt of the sum of squares over every tensor (optax.global_norm)."""
    norms = torch._foreach_norm([t.float() for t in tensors if t is not None])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """optax.clip_by_global_norm: g / norm * max where norm >= max, else g
    (`norm`: their global norm, if known)."""
    norm = global_norm(grads) if norm is None else norm
    if bool(norm < max_norm):
        return list(grads)
    out = torch._foreach_div(list(grads), float(norm))
    torch._foreach_mul_(out, max_norm)
    return out


class AdamW:
    """optax.chain(clip_by_global_norm(grad_clip), adamw(warmup lr, b1, b2,
    eps, weight_decay)) over a fixed list of parameters (updated in place):
    the clip by hand, the update by torch.optim.AdamW (foreach), whose
    arithmetic is optax's (decoupled decay times the learning rate, bias-
    corrected moments, eps outside the square root), with its learning rate
    set from the schedule before each update: the warmup schedule, or
    `schedule` (count → lr) when given. grad_clip None: no clip (a bare
    optax.adamw)."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float, warmup_steps: int = 500,
                 betas=(0.9, 0.96), weight_decay: float = 0.01,
                 grad_clip: Optional[float] = 1.0, eps: float = 1e-8,
                 schedule: Optional[Callable[[int], np.float32]] = None):
        self.params = list(params)
        self.schedule = schedule or warmup_constant_schedule(lr, warmup_steps)
        self.grad_clip = grad_clip
        self.opt = torch.optim.AdamW(self.params, lr=lr, betas=tuple(betas), eps=eps,
                                     weight_decay=weight_decay, foreach=True)
        self.count = 0  # updates applied (adam's count and the schedule's)

    @torch.no_grad()
    def update(self, grads: Sequence[Optional[torch.Tensor]],
               norm: Optional[torch.Tensor] = None) -> bool:
        """One update from grads aligned with the parameters (`norm`: their
        global norm, if known); True (the chain fires on every call)."""
        grads = [torch.zeros_like(p) if g is None else g.to(p.dtype)
                 for p, g in zip(self.params, grads)]
        if self.grad_clip is not None:
            grads = clip_by_global_norm(grads, self.grad_clip, norm)
        for p, g in zip(self.params, grads):
            p.grad = g
        for group in self.opt.param_groups:
            group["lr"] = float(self.schedule(self.count))
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.count += 1
        return True

    def state_dict(self) -> Dict:
        return {"count": self.count, "adamw": self.opt.state_dict()}

    def load_state_dict(self, sd: Dict) -> None:
        self.count = int(sd["count"])
        self.opt.load_state_dict(sd["adamw"])


class MultiSteps:
    """optax.MultiSteps(tx, k): the running mean of k micro-step grads, then
    one update of `tx` (which clips it); in between the parameters stay
    put."""

    def __init__(self, tx: AdamW, every_k: int):
        self.tx, self.every_k = tx, int(every_k)
        self.mini_step = 0  # micro-steps accumulated since the last update
        self.acc = [torch.zeros_like(p, dtype=torch.float32) for p in tx.params]

    @property
    def params(self) -> List[torch.Tensor]:
        return self.tx.params

    @torch.no_grad()
    def update(self, grads: Sequence[Optional[torch.Tensor]],
               norm: Optional[torch.Tensor] = None) -> bool:
        """One micro-step; True when the inner chain fired."""
        grads = [torch.zeros_like(a) if g is None else g.float()
                 for a, g in zip(self.acc, grads)]
        delta = torch._foreach_sub(grads, self.acc)
        torch._foreach_div_(delta, float(self.mini_step + 1))
        torch._foreach_add_(self.acc, delta)
        if self.mini_step < self.every_k - 1:
            self.mini_step += 1
            return False
        fired = self.tx.update(self.acc)
        self.mini_step = 0
        torch._foreach_zero_(self.acc)
        return fired

    def state_dict(self) -> Dict:
        return {"inner": self.tx.state_dict(), "mini_step": self.mini_step, "acc": self.acc}

    def load_state_dict(self, sd: Dict) -> None:
        self.tx.load_state_dict(sd["inner"])
        self.mini_step = int(sd["mini_step"])
        dev = self.params[0].device
        self.acc = [t.to(dev) for t in sd["acc"]]


def make_adamw(params, lr: float, warmup_steps: int = 500, betas=(0.9, 0.96),
               weight_decay: float = 0.01, grad_clip: float = 1.0,
               eps: float = 1e-8) -> AdamW:
    """AdamW with warmup and clipping (gpt/train.py:48-63)."""
    return AdamW(params, lr, warmup_steps, betas, weight_decay, grad_clip, eps)


def make_gan_adam(params, lr: float, betas=(0.8, 0.99), eps: float = 1e-9,
                  decay: float = 0.999875) -> AdamW:
    """AdamW for the codec GAN (vqvae/config.json train block): lr *
    decay^count, weight decay 0.01, no clip."""
    return AdamW(params, lr, betas=betas, weight_decay=0.01, grad_clip=None, eps=eps,
                 schedule=exponential_decay_schedule(lr, decay))


def with_accumulation(tx: AdamW, accumulate_num: int):
    """Gradient accumulation over `accumulate_num` micro-steps: `tx` inside
    MultiSteps when that is above 1, else `tx`."""
    return MultiSteps(tx, accumulate_num) if accumulate_num > 1 else tx


@torch.no_grad()
def ema_update(ema: List[torch.Tensor], params: Sequence[torch.Tensor],
               beta: float = 0.999) -> None:
    """Shadow weights e = beta * e + (1 - beta) * p, in place."""
    torch._foreach_mul_(ema, beta)
    torch._foreach_add_(ema, [p.float() for p in params], alpha=1.0 - beta)


@dataclass
class TrainState:
    """A model (its parameters are the trained state), its optimizer, the
    optional EMA shadow weights (f32, aligned with the parameters) and the
    micro-step counter, which counts applied (finite) micro-steps as
    flax's TrainState.step does."""

    model: nn.Module
    opt: AdamW | MultiSteps
    ema: Optional[List[torch.Tensor]] = None
    step: int = 0

    @classmethod
    def create(cls, model: nn.Module, opt_fn: Callable[[List[torch.Tensor]], AdamW],
               ema: bool = False) -> "TrainState":
        """opt_fn(params) → the optimizer over every parameter of `model`
        (named_parameters order)."""
        params = list(model.parameters())
        return cls(model, opt_fn(params),
                   [p.detach().float().clone() for p in params] if ema else None)

    @property
    def params(self) -> List[torch.Tensor]:
        return self.opt.params

    def state_dict(self) -> Dict:
        return {"model": self.model.state_dict(), "optimizer": self.opt.state_dict(),
                "ema": self.ema, "step": self.step}

    def load_state_dict(self, sd: Dict) -> None:
        self.model.load_state_dict(sd["model"])
        self.opt.load_state_dict(sd["optimizer"])
        dev = self.params[0].device
        self.ema = None if sd["ema"] is None else [t.to(dev) for t in sd["ema"]]
        self.step = int(sd["step"])


@dataclass
class GanState:
    """The codec GAN's paired state (the reference's G_ / D_ checkpoint
    pairs): the generator's TrainState, whose model holds the codebook
    buffers, and the discriminator's. `params` lists both models'
    parameters (the Trainer reads their device)."""

    g: TrainState
    d: TrainState

    @property
    def params(self) -> List[torch.Tensor]:
        return self.g.params + self.d.params

    def state_dict(self) -> Dict:
        return {"g": self.g.state_dict(), "d": self.d.state_dict()}

    def load_state_dict(self, sd: Dict) -> None:
        self.g.load_state_dict(sd["g"])
        self.d.load_state_dict(sd["d"])
