"""The traffic generators are deterministic by seed, and every seed gives
the same sizes of work."""

from __future__ import annotations

import json

import pytest
import torch

from conftest import ROOT, TINY_CYCLE
from portbench import run as bench

SERVE = bench.load(bench.PKG / "traffic" / "serve_batch.py", "kind_serve_batch")
TRAIN = bench.load(bench.PKG / "traffic" / "gpt_train.py", "kind_gpt_train")
PARAMS = json.loads((ROOT / "portbench/workloads/serve.fast.b64.json").read_text())["params"]
CTX1796 = json.loads((ROOT / "portbench/workloads/train.gpt.ctx1796.json").read_text())[
    "params"]["cycle"]


def test_texts_deterministic_and_same_sizes():
    big = 2 ** 31 + 12345
    a, b = SERVE.texts_of(PARAMS, big, 3), SERVE.texts_of(PARAMS, big, 3)
    assert a == b and len(a) == PARAMS["texts_per_call"]
    c = SERVE.texts_of(PARAMS, big + 1, 3)
    assert c != a
    assert sorted(a) == sorted(c) == sorted(SERVE.texts_of(PARAMS, 7, 0))
    assert set(a) == set(PARAMS["texts"])


@pytest.mark.parametrize("candidates", [1, 4])
def test_check_texts_hold_the_longest_and_greedy_rows(candidates):
    import numpy as np

    p = dict(PARAMS, candidates=candidates, check_texts=3)
    texts = SERVE.texts_of(p, 5, 0)
    pick = SERVE.check_texts(p, texts, np.random.default_rng(1))
    greedy = {r // candidates for r in SERVE.greedy_rows(len(texts) * candidates,
                                                          p["greedy_stride"])}
    assert len(pick) == 3 and len(set(pick)) == 3 and set(pick) <= greedy
    assert max(len(texts[t].split()) for t in pick) == max(len(t.split()) for t in PARAMS["texts"])


def test_draws_deterministic_and_greedy_rows():
    shape = (4, 8, 11)
    g1 = SERVE.Draws(99, "cpu", 4).gumbel(shape)
    g2 = SERVE.Draws(99, "cpu", 4).gumbel(shape)
    assert torch.equal(g1, g2)
    assert torch.all(g1[:, [0, 4]] == 0) and torch.all(g1[:, [1, 2, 3]] != 0)
    assert SERVE.call_seed(5, 1) != SERVE.call_seed(5, 2) == SERVE.call_seed(5, 2)


def test_voice_deterministic():
    assert (SERVE.synthetic_voice(0.5, 16000, 3) == SERVE.synthetic_voice(0.5, 16000, 3)).all()
    assert not (SERVE.synthetic_voice(0.5, 16000, 3) == SERVE.synthetic_voice(0.5, 16000, 4)).all()


def test_batches_deterministic_and_padded():
    spec = TINY_CYCLE[0]
    a, b = TRAIN.make_batch(spec, 11, "cpu"), TRAIN.make_batch(spec, 11, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = TRAIN.make_batch(spec, 12, "cpu")
    assert not torch.equal(a["text"], c["text"])
    assert a["text"].shape == (len(spec["text"]), spec["text_pad"])
    row = 0
    assert int((a["text"][row] != 0).sum()) <= spec["text"][row]
    assert torch.all(a["mel_codes"][row, spec["mel"][row]:] == 0)
    assert TRAIN.tokens_of(spec) == sum(spec["text"]) + sum(spec["mel"])


def test_ctx1796_cycle_is_stored_full():
    for spec in CTX1796:
        assert spec["text"] == [256] * 64 and spec["mel"] == [1536] * 64
        assert (spec["text_pad"], spec["mel_pad"]) == (256, 1536)
