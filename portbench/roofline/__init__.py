"""Frozen work counts of the port's kernels: one module per kernel, each
with the device operation names it launches (`KERNELS`, a regular
expression) and `work(...)` → {"flop", "bytes"[, "exp2"]} for one launch at
a shape, counted from what the inputs need: each input byte read once,
each output byte written once. `bound_s` turns a count into the least time
the card could take at the published peaks (peaks.json)."""

from __future__ import annotations


def bound_s(work: dict, peaks: dict) -> float:
    """The larger of products over the bf16 peak, exp2 over the SFUs' rate
    and bytes over the memory rate, in seconds."""
    return max(work["flop"] / peaks["bf16_flop_s"], work.get("exp2", 0.0) / peaks["sfu_exp2_s"],
               work["bytes"] / peaks["hbm_bytes_s"])
