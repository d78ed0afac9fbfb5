"""serve.decode_graph_share on hand-built traces: 0 where no decode step
launched a CUDA graph, 100 where one began inside every `ttts.gpt.decode_step`
range (a graph launch outside every step counts for none), the share where
some did, nothing without the span; listed for both serving cells."""

from __future__ import annotations

import types

import pytest

from conftest import ROOT
from portbench import run as bench
from portbench.trace import WINDOW, Trace

NAME = "serve.decode_graph_share"


def trace(graph_steps, steps: int = 4) -> Trace:
    """`steps` decode steps of 1000 ns each; a cudaGraphLaunch inside the
    steps in `graph_steps`, a kernel launch in every step, and a graph
    launch after the last step."""
    host = [(WINDOW, 0, 100000, 0)]
    for i in range(steps):
        s = 1000 * (i + 1)
        host += [("ttts.gpt.decode_step", s, s + 1000, 0), ("cudaLaunchKernel", s + 100,
                                                            s + 110, 2 * i + 1)]
        if i in graph_steps:
            host.append(("cudaGraphLaunch", s + 500, s + 520, 2 * i + 2))
    host.append(("cudaGraphLaunch", 50000, 50020, 99))
    return Trace(0, 100000, [("k", 60000, 60100, 99)], host)


def read(t):
    return bench.load(bench.PKG / "metrics" / f"{NAME}.py", "metric_graph_share").read(
        types.SimpleNamespace(trace=t))


@pytest.mark.parametrize("graph_steps,want", [((), 0.0), ((0, 1, 2, 3), 100.0),
                                              ((1, 3), 50.0)])
def test_share_of_steps_that_launched_a_graph(graph_steps, want):
    assert read(trace(graph_steps)) == pytest.approx(want, rel=1e-12)


def test_nothing_without_the_span():
    t = trace((0, 1, 2, 3))
    bare = Trace(t.lo, t.hi, t.device, [h for h in t.host if not h[0].startswith("ttts.")])
    assert read(bare) is None and read(None) is None


def test_listed_for_both_serving_cells():
    cells = [w["name"] for w in bench.read_json(ROOT / "BENCHMARK.json")["workloads"]]
    listed = {c for c in cells if NAME in {m["name"] for m in bench.find_cell(ROOT, c).per_layer}}
    assert listed == {"serve.fast.b64", "serve.ultra_fast.b128"}
