"""The port's copies of the data tools (ttts_tpu_torch.data: manifest,
sampler, loader, the GPT and diffusion datasets) give the JAX package's
rows, sidecars, examples, batches and sampler indices exactly, on one
seeded manifest in tmp_path; the port's loader raises a collate error in
the consumer."""

import itertools

import numpy as np
import pytest
import torch

from ttts_tpu.data import datasets as jds
from ttts_tpu.data import manifest as jman
from ttts_tpu.data import sampler as jsam
from ttts_tpu.train import mains as jmains
from ttts_tpu_torch.data import datasets as tds
from ttts_tpu_torch.data import loader as tload
from ttts_tpu_torch.data import manifest as tman
from ttts_tpu_torch.data import sampler as tsam
from ttts_tpu_torch.train import mains as tmains

TEXTS = ["ni3 hao3 shi4 jie4", "jin1 tian1 tian1 qi4 hen3 hao3", "wo3 men5 qu4 gong1 yuan2"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """24 rows: codes 20-150, mels 110-300 frames (one legacy .pth code
    sidecar, one row without sidecars)."""
    d = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    rows = []
    for i in range(24):
        path = str(d / f"u{i:02d}.wav")
        codes = rng.integers(0, 1024, int(rng.integers(20, 151)))
        if i == 5:
            torch.save(torch.as_tensor(codes), path + ".vq.pth")
        elif i != 7:
            tman.save_sidecar(path, "vq", codes)
        if i != 7:
            tman.save_sidecar(path, "mel", rng.standard_normal(
                (int(rng.integers(110, 301)), 100)).astype(np.float32))
        rows.append({"text": TEXTS[i % 3], "path": path})
    tman.write_manifest(d / "m.jsonl", rows)
    return str(d / "m.jsonl")


def _equal(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif hasattr(a, "__dataclass_fields__"):
        for k in a.__dataclass_fields__:
            _equal(getattr(a, k), getattr(b, k))
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


def test_manifest_and_sidecars(corpus):
    rows = tman.read_manifest(corpus)
    assert rows == jman.read_manifest(corpus)
    for r in rows:
        for kind in ("vq", "mel"):
            assert tman.sidecar_shape(r["path"], kind) == jman.sidecar_shape(r["path"], kind)
            _equal(tman.load_sidecar(r["path"], kind), jman.load_sidecar(r["path"], kind))


@pytest.mark.parametrize("name", ["GptTtsDataset", "DiffusionDataset"])
def test_datasets_items_and_collate(corpus, name):
    kw = lambda: ({"rng": np.random.default_rng(3)} if name == "DiffusionDataset"  # noqa: E731
                  else {})
    t, j = getattr(tds, name)(corpus, **kw()), getattr(jds, name)(corpus, **kw())
    assert t.lengths() == j.lengths() and len(t) == len(j) == 24
    items = [(t[i], j[i]) for i in range(len(t))]  # in order: the refer split's draws
    assert items[7] == (None, None)
    for a, b in items:
        _equal(a, b)
    for chunk in (slice(0, 4), slice(4, 9), slice(20, 24)):
        _equal(t.collate([a for a, _ in items[chunk]]), j.collate([b for _, b in items[chunk]]))
    assert t.collate([None]) is None and j.collate([None]) is None


@pytest.mark.parametrize("replicas", [1, 2])
def test_bucket_sampler_indices(replicas):
    lengths = list(np.random.default_rng(1).integers(-1, 700, 200))
    bounds = list(range(0, 641, 64))
    for rank in range(replicas):
        t = tsam.DistributedBucketSampler(lengths, 8, bounds, replicas, rank, seed=5)
        j = jsam.DistributedBucketSampler(lengths, 8, bounds, replicas, rank, seed=5)
        assert len(t) == len(j)
        for epoch in range(3):
            t.set_epoch(epoch)
            j.set_epoch(epoch)
            assert list(t) == list(j)
    assert list(tsam.BucketSampler(lengths, 4, bounds, seed=2)) == list(
        jsam.BucketSampler(lengths, 4, bounds, seed=2))


def test_bucketed_loader_batches(corpus):
    """The trainers' loaders (GPT: code buckets, 4 workers) over two epochs."""
    t = tmains._bucketed_batches(tds.GptTtsDataset(corpus), 4, 7, range(0, 641, 64))
    j = jmains._bucketed_batches(jds.GptTtsDataset(corpus), 4, 7, range(0, 641, 64))
    n = 2 * len(list(tsam.DistributedBucketSampler(tds.GptTtsDataset(corpus).lengths(), 4,
                                                   list(range(0, 641, 64)), seed=7)))
    pairs = list(zip(itertools.islice(iter(t), n), itertools.islice(iter(j), n)))
    assert n >= 10 and len(pairs) == n
    for a, b in pairs:
        _equal(a, b)


def test_loader_raises_a_collate_error():
    def collate(examples):
        raise ValueError("bad batch")

    loader = tload.DataLoader(list(range(8)), [[0, 1], [2, 3]], collate, num_workers=1)
    with pytest.raises(ValueError, match="bad batch"):
        list(loader)


class _Recorded(tds.DiffusionDataset):
    """DiffusionDataset that records the rows it loads, in order."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.loaded = []

    def __getitem__(self, idx):
        self.loaded.append(idx)
        return super().__getitem__(idx)


@pytest.mark.parametrize("taken", [3, 7])
def test_epoch_loader_resumes_without_loading_finished_batches(corpus, taken):
    """The diffusion trainer's loader (mel buckets of 4, one worker, the
    refer split's draws) after `taken` batches (7: past an epoch's end): a
    new loader given its position yields the 4 batches the first goes on to
    yield, draws included, and the first rows it loads are theirs, not
    those of the batches before them."""
    def make(dataset):
        return tmains._bucketed_batches(dataset, 4, 7, range(0, 449, 64), num_workers=1)

    before = _Recorded(corpus)
    first = make(before)
    it = iter(first)
    for _ in range(taken):
        next(it)
    position = first.state_dict()
    want = [next(it) for _ in range(4)]
    after = _Recorded(corpus)
    resumed = make(after)
    resumed.load_state_dict(position)
    got = list(itertools.islice(iter(resumed), 4))
    for a, b in zip(got, want):
        _equal(a, b)
    assert after.loaded[:16] == before.loaded[4 * taken:4 * taken + 16]
