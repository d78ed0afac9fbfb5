"""The training loop, port of ttts_tpu/train/trainer.py: cycle a host data
iterator, run the step, log scalars every `log_every`, keep-N checkpoints
every `save_freq`, auto-resume from the latest checkpoint, abort (with a
checkpoint) after a run of non-finite steps, flush a checkpoint on SIGTERM,
and call an evaluation hook (`eval_fn(step, state, writer)`, see
train/eval_hooks.py) every `eval_freq` steps (default `save_freq`), after
the step's log and checkpoint, as the JAX trainer does.

The state is a TrainState, or the codec GAN's GanState (generator and
discriminator, checkpointed together); the Trainer reads only its
state_dict, load_state_dict and its parameters' device.

It trains on one device: a mesh asking for more than one raises (multi-GPU
is ROADMAP.md queue 1, item 9). A resumed run repeats the uninterrupted
run: its checkpoint holds the key generator's state and, for a data source
that keeps a position (data.loader.EpochLoader: epoch, batch, the dataset's
draws), that position, so step n + 1 sees the batch and the key it would
have seen without loading the batches before it. Any other iterable starts
over.
"""

from __future__ import annotations

import collections
import pathlib
import signal
import threading
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ttts_tpu_torch.train.checkpoints import CheckpointManager
from ttts_tpu_torch.train.state import TrainState
from ttts_tpu_torch.utils.logging import SummaryWriter, get_logger


class PreemptionRequested(Exception):
    """Raised inside Trainer.train after a SIGTERM-triggered final save."""


def mesh_devices(mesh) -> int:
    """The devices a MeshConfig asks for explicitly (data = -1, all visible
    devices in the JAX package, counts as the one device here)."""
    if mesh is None:
        return 1
    return max(mesh.data, 1) * max(mesh.model, 1) * max(mesh.dcn, 1)


class Trainer:
    """Drives (state, batch, key) -> metrics steps on one device."""

    def __init__(self, step_fn: Callable, state: TrainState, data_iter: Iterable,
                 logs_folder: str, train_steps: int, save_freq: int = 1000,
                 keep_ckpts: int = 3, log_every: int = 100, seed: int = 1234, mesh=None,
                 eval_fn: Optional[Callable] = None, eval_freq: Optional[int] = None,
                 max_consecutive_nonfinite: int = 25, device=None):
        if mesh_devices(mesh) > 1:
            raise NotImplementedError(
                f"the mesh asks for {mesh_devices(mesh)} devices; this trainer runs on one "
                "(multi-GPU training is ROADMAP.md queue 1, item 9)")
        self.step_fn = step_fn
        self.state = state
        self.data_iter = data_iter
        self.train_steps = train_steps
        self.save_freq = save_freq
        self.log_every = log_every
        self.eval_fn = eval_fn
        self.eval_freq = eval_freq or save_freq
        self.device = torch.device(device) if device is not None else state.params[0].device
        self.logs_folder = pathlib.Path(logs_folder)
        self.writer = SummaryWriter(self.logs_folder / "tb")
        self.ckpt = CheckpointManager(self.logs_folder / "ckpt", keep=keep_ckpts)
        self.logger = get_logger("trainer", str(self.logs_folder / "train.log"))
        self.gen = torch.Generator().manual_seed(seed)  # one key per step
        self.step = 0
        self.max_consecutive_nonfinite = max_consecutive_nonfinite
        self._nonfinite_run = 0
        self._preempted = False
        # the last steps' {"step", "seconds", **metrics} (seconds on the host's
        # clock: the dispatch's time unless step_fn synchronises)
        self.history = collections.deque(maxlen=1000)

    def _install_preemption_handler(self):
        """SIGTERM → a flag; the loop saves at the top of the next step and
        raises PreemptionRequested. Main thread only; a previous handler is
        chained."""
        self._preempted = False
        if threading.current_thread() is not threading.main_thread():
            return
        prev = signal.getsignal(signal.SIGTERM)

        def handler(signum, frame):
            self._preempted = True
            if callable(prev) and prev not in (signal.SIG_IGN, signal.SIG_DFL):
                prev(signum, frame)

        signal.signal(signal.SIGTERM, handler)

    def _tree(self) -> Dict:
        tree = {"state": self.state.state_dict(), "generator": self.gen.get_state(),
                "step": self.step}
        if hasattr(self.data_iter, "state_dict"):
            tree["data"] = self.data_iter.state_dict()
        return tree

    def save(self):
        self.ckpt.save(self.step, self._tree())

    def maybe_resume(self):
        """Auto-resume from the latest checkpoint."""
        latest = self.ckpt.latest_step()
        if latest is not None:
            _, tree = self.ckpt.restore(latest)
            self.state.load_state_dict(tree["state"])
            self.gen.set_state(tree["generator"])
            if "data" in tree:
                self.data_iter.load_state_dict(tree["data"])
            self.step = int(tree["step"])
            self.logger.info("resumed from step %d", latest)

    def _put(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(np.asarray(v))
            out[k] = (t.long() if not t.is_floating_point() else t).to(self.device)
        return out

    def _note_skip(self, skipped: float):
        self._nonfinite_run = self._nonfinite_run + 1 if skipped > 0 else 0
        if self._nonfinite_run >= self.max_consecutive_nonfinite:
            if self.ckpt.latest_step() != self.step:
                try:
                    self.save()
                except Exception:
                    self.logger.exception("divergence-abort checkpoint failed")
            raise RuntimeError(
                f"aborting: {self._nonfinite_run} consecutive non-finite-gradient steps "
                f"(model diverged); last good state checkpointed at step {self.step}")

    def _next(self, it):
        try:
            return it, next(it)
        except StopIteration:
            it = iter(self.data_iter)
            return it, next(it)

    def train(self) -> TrainState:
        it = iter(self.data_iter)
        t0 = time.perf_counter()
        self._install_preemption_handler()
        while self.step < self.train_steps:
            if self._preempted:
                self.logger.info("SIGTERM received — flushing checkpoint at step %d", self.step)
                if self.ckpt.latest_step() != self.step:
                    self.save()
                raise PreemptionRequested(f"preempted at step {self.step}; checkpoint flushed")
            it, batch = self._next(it)
            if batch is None:  # an empty collated batch is skipped (gpt/train.py:101)
                continue
            key = int(torch.randint(2 ** 62, (1,), generator=self.gen))
            ts = time.perf_counter()
            metrics = self.step_fn(self.state, self._put(batch), key)
            self.step += 1
            self.history.append({"step": self.step, "seconds": time.perf_counter() - ts,
                                 **metrics})
            self._note_skip(float(metrics.get("nonfinite_skipped", 0.0)))
            if self.step % self.log_every == 0:
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                t0 = time.perf_counter()
                metrics["steps_per_sec"] = self.log_every / dt
                self.writer.summarize(self.step, scalars=metrics)
                self.logger.info("step %d %s", self.step, metrics)
            if self.step % self.save_freq == 0:
                self.save()
            if self.eval_fn is not None and self.step % self.eval_freq == 0:
                self.eval_fn(self.step, self.state, self.writer)
        if self.ckpt.latest_step() != self.step:
            self.save()
        return self.state
