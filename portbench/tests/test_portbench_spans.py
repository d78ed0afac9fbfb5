"""The readers of the program's own spans (portbench/spans.py and the five
metrics that use it) on synthetic timelines with known host ranges, device
intervals and correlation ids (torch ops whose own ids coincide with a
launch's, as torch.profiler records them, are no launch); nothing on a
trace without the spans (a program that records none); each metric
listed for exactly its cells."""

from __future__ import annotations

import types

import pytest

from conftest import ROOT
from portbench import run as bench
from portbench.trace import WINDOW, Trace

NEW = {"serve.sampling_ms_per_step": {"serve.fast.b64", "serve.ultra_fast.b128"},
       "serve.decode_device_ms_per_step": {"serve.fast.b64", "serve.ultra_fast.b128"},
       "serve.decode_idle_share": {"serve.fast.b64", "serve.ultra_fast.b128"},
       "train.backward_share": {"train.gpt.ctx1796"},
       "train.update_share": {"train.gpt.ctx1796"}}


def _launch(t: int, corr: int):
    return ("cudaLaunchKernel", t, t + 10, corr)


def serve_trace() -> Trace:
    """Two decode steps of a decode stage, each with a sampler span; one
    kernel in each sampler, one more in each step, one after the stage; a
    torch op after the stage whose id is the first launch's."""
    host = [(WINDOW, 0, 10000, 0), ("ttts.stage.gpt_decode", 1000, 5000, 0),
            ("ttts.gpt.decode_step", 1000, 2000, 0), ("ttts.gpt.decode_step", 2000, 3000, 0),
            ("ttts.gpt.sample", 1000, 1400, 0), ("ttts.gpt.sample", 2000, 2400, 0),
            _launch(1100, 1), _launch(1500, 2), _launch(2100, 3), _launch(2500, 4),
            _launch(6000, 5), ("aten::mul", 6500, 6600, 1)]
    device = [("k1", 1200, 1300, 1), ("k2", 1600, 1900, 2), ("k3", 2200, 2260, 3),
              ("k4", 2600, 2700, 4), ("k5", 6100, 7000, 5)]
    return Trace(0, 10000, device, host)


def train_trace() -> Trace:
    """A step's forward, backward (with a launch from a second host thread
    inside its range) and update, with one kernel outside every span and a
    torch op in the update whose id is a backward launch's."""
    host = [(WINDOW, 0, 5000, 0), ("ttts.train.forward", 0, 1000, 0),
            ("ttts.train.backward", 1000, 3000, 0), ("ttts.train.update", 3000, 4000, 0),
            _launch(100, 1), _launch(1100, 2), _launch(2000, 3), _launch(3100, 4),
            _launch(4500, 5), ("aten::add", 3500, 3510, 2)]
    device = [("f", 200, 400, 1), ("b1", 1200, 1700, 2), ("b2", 2100, 2400, 3),
              ("u", 3200, 3300, 4), ("x", 4600, 4700, 5)]
    return Trace(0, 5000, device, host)


def bare(trace: Trace) -> Trace:
    """The trace of a program that records no `ttts.*` range."""
    return Trace(trace.lo, trace.hi, trace.device,
                 [h for h in trace.host if not h[0].startswith("ttts.")])


def reader(name: str):
    return bench.load(bench.PKG / "metrics" / f"{name}.py",
                      f"portbench_metric_{name.replace('.', '_')}").read


WANT = {"serve.sampling_ms_per_step": (serve_trace, (100 + 60) * 1e-9 * 1e3 / 2),
        "serve.decode_device_ms_per_step": (serve_trace, (100 + 300 + 60 + 100) * 1e-9 * 1e3 / 2),
        "serve.decode_idle_share": (serve_trace, 100.0 * (1 - (100 + 300 + 60 + 100) / 4000)),
        "train.backward_share": (train_trace, 100.0 * (500 + 300) / 1200),
        "train.update_share": (train_trace, 100.0 * 100 / 1200)}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_gives_its_known_value(name):
    make, want = WANT[name]
    got = reader(name)(types.SimpleNamespace(trace=make()))
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_gives_nothing_without_its_spans(name):
    make, _ = WANT[name]
    assert reader(name)(types.SimpleNamespace(trace=bare(make()))) is None
    assert reader(name)(types.SimpleNamespace(trace=None)) is None


def test_spans_outside_the_window_are_not_counted():
    t = serve_trace()
    t.host.append(("ttts.gpt.sample", 20000, 20400, 0))
    assert reader("serve.sampling_ms_per_step")(types.SimpleNamespace(trace=t)) == \
        pytest.approx((100 + 60) * 1e-9 * 1e3 / 2, rel=1e-12)


@pytest.mark.parametrize("name", sorted(NEW))
def test_metric_listed_for_exactly_its_cells(name):
    cells = [w["name"] for w in bench.read_json(ROOT / "BENCHMARK.json")["workloads"]]
    listed = {c for c in cells if name in {m["name"] for m in bench.find_cell(ROOT, c).per_layer}}
    assert listed == NEW[name]
