"""Timestep schedule samplers, port of ttts_tpu/diffusion/resample.py
(reference ttts/utils/resample.py:9-196). Each `sample(generator, batch)`
draws (t, importance weights) from a torch.Generator where the JAX package
takes a key; the loss-second-moment history is host-side numpy, updated
between steps."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


class UniformSampler:
    """w_t = 1 for all t (resample.py:62-70)."""

    def __init__(self, num_timesteps: int):
        self.num_timesteps = num_timesteps

    def sample(self, generator: Optional[torch.Generator], batch: int, device=None):
        t = torch.randint(0, self.num_timesteps, (batch,), generator=generator, device=device)
        return t, torch.ones((batch,), device=device)


class DeterministicSampler:
    """Cycles timesteps deterministically (resample.py:71-90, a debug tool)."""

    def __init__(self, num_timesteps: int):
        self.num_timesteps = num_timesteps
        self._next = 0

    def sample(self, generator, batch: int, device=None):
        t = (np.arange(batch) + self._next) % self.num_timesteps
        self._next = int((self._next + batch) % self.num_timesteps)
        return torch.as_tensor(t, device=device), torch.ones((batch,), device=device)


class LossSecondMomentResampler:
    """Importance-sample t ∝ sqrt(E[loss^2]) over a 10-sample history per t,
    uniform until every t is warm (resample.py:159-196)."""

    def __init__(self, num_timesteps: int, history_per_term: int = 10,
                 uniform_prob: float = 0.001):
        self.num_timesteps = num_timesteps
        self.history_per_term = history_per_term
        self.uniform_prob = uniform_prob
        self._loss_history = np.zeros((num_timesteps, history_per_term), np.float64)
        self._loss_counts = np.zeros((num_timesteps,), np.int64)

    def _warmed_up(self) -> bool:
        return bool((self._loss_counts == self.history_per_term).all())

    def weights(self) -> np.ndarray:
        if not self._warmed_up():
            return np.ones((self.num_timesteps,), np.float64) / self.num_timesteps
        w = np.sqrt(np.mean(self._loss_history ** 2, axis=-1))
        w /= w.sum()
        return w * (1 - self.uniform_prob) + self.uniform_prob / len(w)

    def sample(self, generator, batch: int, device=None):
        w = torch.as_tensor(self.weights(), dtype=torch.float32)
        t = torch.multinomial(w, batch, replacement=True, generator=generator)
        weights = 1.0 / (self.num_timesteps * w[t])  # importance weights 1 / (N p(t))
        return t.to(device), weights.to(device)

    def update_with_losses(self, ts, losses):
        for t, loss in zip(np.asarray(ts), np.asarray(losses)):
            t = int(t)
            if self._loss_counts[t] == self.history_per_term:
                self._loss_history[t, :-1] = self._loss_history[t, 1:]
                self._loss_history[t, -1] = loss
            else:
                self._loss_history[t, self._loss_counts[t]] = loss
                self._loss_counts[t] += 1


def create_named_schedule_sampler(name: str, num_timesteps: int):
    """The sampler of this name (resample.py:9-30)."""
    if name == "uniform":
        return UniformSampler(num_timesteps)
    if name == "deterministic":
        return DeterministicSampler(num_timesteps)
    if name == "loss-second-moment":
        return LossSecondMomentResampler(num_timesteps)
    raise NotImplementedError(name)
