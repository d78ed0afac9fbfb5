"""The trace reduction on a synthetic timeline: busy time as the union of
device intervals, idle gaps named by the host, device time under a range."""

from __future__ import annotations

from portbench.trace import Trace, gaps, short_name, union_length


def test_union_and_gaps():
    iv = [(10, 20), (15, 30), (40, 50), (45, 46), (70, 120)]
    assert union_length(iv, 0, 100) == 20 + 10 + 30
    assert union_length(iv, 12, 42) == 18 + 2
    assert gaps(iv, 0, 100) == [(0, 10), (30, 40), (50, 70)]
    assert union_length([], 0, 10) == 0 and gaps([], 0, 10) == [(0, 10)]


def test_trace_busy_idle_and_ranges():
    dev = [("void k1<32, false, true>(CUtensorMap, int)", 100, 200, 1),
           ("k2", 150, 300, 2), ("k1<32, false, true>", 500, 600, 3)]
    host = [("portbench.window", 0, 1000, 0), ("Optimizer.step#AdamW.step", 400, 700, 0),
            ("cudaLaunchKernel", 90, 95, 1), ("cudaLaunchKernel", 140, 145, 2),
            ("cudaLaunchKernel", 450, 455, 3), ("aten::item", 300, 500, 0)]
    t = Trace(0, 1000, dev, host)
    assert t.window_s == 1e-6 and abs(t.busy_s - 300e-9) < 1e-15
    assert t.kernels(r"k1<32, false, true>") == (2, 200e-9)
    idle = dict(t.idle_gaps())
    assert abs(idle["aten::item"] - 200e-9) < 1e-15  # the gap 300-500 sits inside aten::item
    assert abs(sum(idle.values()) - 700e-9) < 1e-15
    assert abs(t.under_range(r"^Optimizer") - 100e-9) < 1e-15  # k1 launched at 450
    assert t.by_name()[0][0] == "k1<32, false, true>"


def test_short_name():
    assert short_name("void flash_fwd_sm90<64>(CUtensorMap, float)") == "flash_fwd_sm90<64>"
