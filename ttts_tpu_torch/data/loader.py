"""Host data loader, port of ttts_tpu/data/loader.py: sampler → dataset →
collate, with a background thread pool for prefetch (in place of torch
DataLoader worker processes, ttts/gpt/train.py num_workers=32). With more
than one worker the examples of a batch load in any order: a dataset that
draws from its own generator in __getitem__ (DiffusionDataset) repeats its
draws only with num_workers=1. An exception in the producer (a collate that
fails) is raised in the consumer; the JAX package's loader ends the epoch
there instead, so that EpochLoader spins through empty epochs.

EpochLoader keeps its position (epoch, batches taken in it, and the state of
the dataset's generator after them) in `state_dict`; a loader given that
position skips the epoch's finished index lists without loading them and
goes on with the next batch and the same draws."""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, Iterator, List, Optional


def _draw_state(dataset) -> Optional[Dict]:
    """The state of the dataset's own numpy generator (`dataset.rng`), if
    it draws."""
    rng = getattr(dataset, "rng", None)
    return None if rng is None else rng.bit_generator.state


class DataLoader:
    def __init__(self, dataset, batch_sampler: Iterable[List[int]],
                 collate_fn: Callable, num_workers: int = 4, prefetch: int = 4):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.collate = collate_fn
        self.num_workers = num_workers
        self.prefetch = prefetch

    def __iter__(self) -> Iterator:
        return (batch for batch, _ in self.positioned())

    def positioned(self, start: int = 0) -> Iterator:
        """(batch, the dataset generator's state after it) from the
        `start`-th index list on; the lists before it are not loaded."""
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        DONE = object()
        failed = []

        def produce():
            try:
                for i, idxs in enumerate(self.batch_sampler):
                    if i < start:
                        continue
                    examples = list(pool.map(self.dataset.__getitem__, idxs))
                    q.put((self.collate(examples), _draw_state(self.dataset)))
            except BaseException as e:  # handed to the consumer
                failed.append(e)
            finally:
                q.put(DONE)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is DONE:
                break
            yield item
        pool.shutdown(wait=False)
        if failed:
            raise failed[0]

    def __len__(self):
        try:
            return len(self.batch_sampler)  # type: ignore[arg-type]
        except TypeError:
            return 0


class EpochLoader:
    """Re-iterates a DistributedBucketSampler-backed loader with a new epoch
    seed each pass (vqvae/train.py epoch loop semantics), keeping its
    position for a resume."""

    def __init__(self, make_loader: Callable[[int], DataLoader]):
        self.make_loader = make_loader
        self.epoch = 0
        self.batch = 0  # batches of this epoch taken
        self.draws = None  # the dataset generator's state after them
        self._restore_draws = False

    def state_dict(self) -> Dict:
        return {"epoch": self.epoch, "batch": self.batch, "draws": self.draws}

    def load_state_dict(self, sd: Dict) -> None:
        self.epoch, self.batch, self.draws = int(sd["epoch"]), int(sd["batch"]), sd["draws"]
        self._restore_draws = self.draws is not None

    def __iter__(self):
        while True:
            loader = self.make_loader(self.epoch)
            if self._restore_draws:
                loader.dataset.rng.bit_generator.state = self.draws
                self._restore_draws = False
            for batch, self.draws in loader.positioned(self.batch):
                self.batch += 1
                yield batch
            self.epoch, self.batch = self.epoch + 1, 0
