"""Length-bucketed batch sampling, port of ttts_tpu/data/sampler.py (the
VITS bucket samplers, ttts/vqvae/dataset.py BucketSampler:115,
DistributedBucketSampler:212): items are binned by length between
boundaries, each batch is drawn from a single bucket (bounding padding
waste and the number of distinct batch shapes), buckets are padded to a
multiple of (batch_size x num_replicas), shuffled with an epoch-seeded
numpy generator, and each replica takes the rank-strided slice
ids_bucket[rank::num_replicas] (dataset.py:277). The same seed gives the
JAX package's batches."""

from __future__ import annotations

from typing import Iterator, List, Sequence


class DistributedBucketSampler:
    def __init__(
        self,
        lengths: Sequence[int],
        batch_size: int,
        boundaries: Sequence[int],
        num_replicas: int = 1,
        rank: int = 0,
        shuffle: bool = True,
        seed: int = 1234,
    ):
        self.lengths = list(lengths)
        self.batch_size = batch_size
        self.boundaries = list(boundaries)
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

        self.buckets = self._create_buckets()
        self.num_samples_per_bucket = []
        total = batch_size * num_replicas
        for b in self.buckets:
            rem = (total - (len(b) % total)) % total
            self.num_samples_per_bucket.append(len(b) + rem)

    def _bisect(self, x: int) -> int:
        for i in range(len(self.boundaries) - 1):
            if self.boundaries[i] < x <= self.boundaries[i + 1]:
                return i
        return -1

    def _create_buckets(self) -> List[List[int]]:
        buckets: List[List[int]] = [[] for _ in range(len(self.boundaries) - 1)]
        for i, l in enumerate(self.lengths):
            b = self._bisect(l)
            if b >= 0:
                buckets[b].append(i)
        return [b for b in buckets if b]

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[List[int]]:
        import numpy as np

        g = np.random.default_rng(self.seed + self.epoch)
        batches = []
        for bucket, n_total in zip(self.buckets, self.num_samples_per_bucket):
            ids = list(g.permutation(len(bucket))) if self.shuffle else list(range(len(bucket)))
            # pad with wrapped repeats to a multiple of total batch
            rem = n_total - len(bucket)
            ids = ids + (ids * (rem // max(len(bucket), 1)) + ids[: rem % max(len(bucket), 1)])
            ids = ids[self.rank :: self.num_replicas][: n_total // self.num_replicas]
            for k in range(0, len(ids), self.batch_size):
                chunk = ids[k : k + self.batch_size]
                if len(chunk) == self.batch_size:
                    batches.append([bucket[j] for j in chunk])
        if self.shuffle:
            order = g.permutation(len(batches))
            batches = [batches[i] for i in order]
        return iter(batches)

    def __len__(self):
        return sum(
            n // self.num_replicas // self.batch_size for n in self.num_samples_per_bucket
        )


class BucketSampler(DistributedBucketSampler):
    """Single-process variant (ttts/vqvae/dataset.py:115-210)."""

    def __init__(self, lengths, batch_size, boundaries, shuffle=True, seed=1234):
        super().__init__(lengths, batch_size, boundaries, 1, 0, shuffle, seed)
