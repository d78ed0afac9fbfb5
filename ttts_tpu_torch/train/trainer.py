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

Data parallel (`mesh`: a DeviceMesh of parallel.make_mesh with the batch
axes; the JAX trainer's multi-host path, trainer.py:71-84, 128-156): one
process per GPU, each with its own data iterator that yields this rank's
batches (the rank-strided samplers of train/mains.py), as each JAX process
loads its own shard; the step function averages the gradients over the
batch ranks (train/steps.py). Every step the ranks agree, in small
all-reduces, on a preemption, on skipping an empty batch and on the
shapes of their arrays. The leading dimension must be the same on every
rank (the JAX package asserts it, as a replicated fallback would run
different programs per process); every other dimension is zero-padded to
its largest size over the ranks. The collates pad each batch to its own
longest row with zeros and carry the lengths, so the padded batches are
the rows of the batch one process would collate from all of them, and the
global pools, draws and loss means of the step see that batch's shapes.
Only the primary process writes scalars and runs the eval
hooks; log files are per process (train.p<rank>.log past rank 0);
checkpoints are written by rank 0 between barriers and read by every rank
(train/checkpoints.py). A resumed run repeats the uninterrupted run: its
checkpoint holds the key generator's state and, for a data source that
keeps a position (data.loader.EpochLoader: epoch, batch, the dataset's
draws), that position, so step n + 1 sees the batch and the key it would
have seen without loading the batches before it. Any other iterable starts
over.
"""

from __future__ import annotations

import collections
import functools
import pathlib
import signal
import threading
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ttts_tpu_torch.parallel.mesh import is_primary
from ttts_tpu_torch.train.checkpoints import CheckpointManager
from ttts_tpu_torch.train.state import TrainState
from ttts_tpu_torch.utils.logging import SummaryWriter, get_logger


class PreemptionRequested(Exception):
    """Raised inside Trainer.train after a SIGTERM-triggered final save."""


class _NullWriter:
    """The scalar sink of a process other than the primary one."""

    def summarize(self, *args, **kwargs):
        pass

    def close(self):
        pass


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


class Trainer:
    """Drives (state, batch, key) -> metrics steps on this process's device."""

    def __init__(self, step_fn: Callable, state: TrainState, data_iter: Iterable,
                 logs_folder: str, train_steps: int, save_freq: int = 1000,
                 keep_ckpts: int = 3, log_every: int = 100, seed: int = 1234, mesh=None,
                 eval_fn: Optional[Callable] = None, eval_freq: Optional[int] = None,
                 max_consecutive_nonfinite: int = 25, device=None):
        # with a mesh the step takes it: step_fn(state, batch, key, mesh=mesh)
        self.step_fn = step_fn if mesh is None else functools.partial(step_fn, mesh=mesh)
        self.state = state
        self.data_iter = data_iter
        self.train_steps = train_steps
        self.save_freq = save_freq
        self.log_every = log_every
        self.eval_fn = eval_fn
        self.eval_freq = eval_freq or save_freq
        self.device = torch.device(device) if device is not None else state.params[0].device
        self.logs_folder = pathlib.Path(logs_folder)
        self._primary = is_primary()
        self.writer = (SummaryWriter(self.logs_folder / "tb") if self._primary
                       else _NullWriter())
        self.ckpt = CheckpointManager(self.logs_folder / "ckpt", keep=keep_ckpts)
        log_name = "train.log" if self._primary else f"train.p{dist.get_rank()}.log"
        self.logger = get_logger("trainer", str(self.logs_folder / log_name))
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
        latest, tree = self.ckpt.restore()
        if latest is not None:
            self.state.load_state_dict(tree["state"])
            self.gen.set_state(tree["generator"])
            if "data" in tree:
                self.data_iter.load_state_dict(tree["data"])
            self.step = int(tree["step"])
            self.logger.info("resumed from step %d", latest)

    def _agree(self, *flags: int) -> list:
        """The maximum of each integer flag over every process (the flags as
        they are in a single process)."""
        if _world() == 1:
            return list(flags)
        v = torch.tensor(flags, dtype=torch.int64, device=self.device)
        dist.all_reduce(v, op=dist.ReduceOp.MAX)
        return v.tolist()

    def _common(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """The batch with every array zero-padded to the largest shape it
        has on any process (one all-reduce of the shapes); raises when the
        ranks' batches differ in rows."""
        if _world() == 1:
            return batch
        arrays = {k: np.asarray(v) for k, v in sorted(batch.items())}
        rows = len(next(iter(arrays.values())))
        *shape, least = self._agree(*(d for v in arrays.values() for d in v.shape), -rows)
        if -least != shape[0]:
            raise ValueError(f"the ranks' batches differ in size ({-least} to {shape[0]} rows): "
                             "a data-parallel step needs the same rows on every rank")
        out, i = {}, 0
        for k, v in arrays.items():
            target = shape[i:i + v.ndim]
            i += v.ndim
            out[k] = np.pad(v, [(0, m - n) for n, m in zip(v.shape, target)])
        return out

    def _put(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """This rank's batch on its device."""
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
            if self._agree(int(self._preempted))[0]:  # on any rank: all save and stop
                self.logger.info("SIGTERM received — flushing checkpoint at step %d", self.step)
                if self.ckpt.latest_step() != self.step:
                    self.save()
                raise PreemptionRequested(f"preempted at step {self.step}; checkpoint flushed")
            it, batch = self._next(it)
            # an empty collated batch is skipped (gpt/train.py:101), on every rank
            dims = 0 if batch is None else sum(np.ndim(v) for v in batch.values())
            empty, most, least = self._agree(int(batch is None), dims, -dims)
            if empty:
                continue
            if most != -least:
                raise ValueError(f"the ranks' batches differ in their arrays ({-least} to {most} "
                                 "dimensions in all)")
            batch = self._common(batch)
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
            if self.eval_fn is not None and self.step % self.eval_freq == 0 and self._primary:
                self.eval_fn(self.step, self.state, self.writer)
        if self.history and self.step % self.log_every:  # the last step's metrics too
            last = {k: float(v) for k, v in self.history[-1].items() if k != "step"}
            self.logger.info("step %d %s", self.step, last)
        if self.ckpt.latest_step() != self.step:
            self.save()
        return self.state
