"""The frozen roofline arithmetic gives back the bounds PERF.md has quoted."""

from __future__ import annotations

import pytest

from portbench import run as bench
from portbench.roofline import bound_s


@pytest.mark.parametrize("kernel, shape, us", [
    ("flash_fwd", (64, 1796, 8, 64), 213.9), ("flash_bwd", (64, 1796, 8, 64), 534.7),
    ("flash_bias", (2, 1600, 16, 32), 10.6), ("resblock", (2, 1600, 512), 6.8)])
def test_bounds(kernel, shape, us):
    got = bound_s(bench.roofline(kernel).work(*shape), bench.peaks()) * 1e6
    assert round(got, 1) == us


def test_train_mfu_counts_unpadded_rows():
    """A padded batch's model FLOPs are its rows' own lengths, not the pad."""
    import types

    from portbench import flops

    g = {"model_dim": 64, "layers": 2, "heads": 2, "number_text_tokens": 255,
         "number_mel_codes": 1026}
    spec = {"text": [10, 4], "mel": [30, 7], "text_pad": 16, "mel_pad": 32}
    ctx = types.SimpleNamespace(cfg={"ttts": {"gpt": g}}, params={"cycle": [spec]})
    r = types.SimpleNamespace(ctx=ctx, records=[{"batch": 0}] * 3, window_s=2.0,
                              peaks={"bf16_flop_s": 1e12})
    mfu = bench.load(bench.PKG / "metrics" / "train.mfu.py", "metric_train_mfu").read(r)
    rows = sum(flops.gpt_train_step(1, t, m, 64, 2, 256, 1026) for t, m in [(10, 30), (4, 7)])
    padded = flops.gpt_train_step(2, 16, 32, 64, 2, 256, 1026)
    assert mfu == pytest.approx(100.0 * 3 * rows / 2e12) and rows < padded
