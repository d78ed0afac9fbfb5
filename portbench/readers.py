"""What the per-layer metric files share: stage times of the staged
calls, the call shapes a roofline needs, and a kernel's share of its
roofline over the traced units."""

from __future__ import annotations

import functools
import statistics
from typing import Iterable, List, Optional, Tuple

from portbench.roofline import bound_s


def stage_mean(r, stage: str, per: float = 1.0) -> Optional[float]:
    """The mean over the staged calls (after a traced run's window) of a
    stage's time (ms) over `per`, or None where they recorded none."""
    vals = [rec["stages"][stage] for rec in r.staged if stage in rec.get("stages", {})]
    return statistics.fmean(vals) * 1e3 / per if vals else None


def roofline_share(r, kernel: str, launches: Iterable[Tuple[int, tuple]]) -> Optional[float]:
    """The kernel's share (%) of its roofline over the traced units: the
    bound of every launch the units made ((count, shape) pairs), over the
    device time of the kernel's operations in the trace, scaled to the
    launches expected where the profiler caught fewer. None where the
    trace holds none of its operations."""
    mod = r.roofline(kernel)
    per_call = getattr(mod, "LAUNCHES_PER_CALL", 1)
    bound, expected = 0.0, 0
    for count, shape in launches:
        bound += count * bound_s(mod.work(*shape), r.peaks)
        expected += count * per_call
    seen, seconds = r.trace.kernels(mod.KERNELS)
    if not seen or not seconds:
        return None
    return 100.0 * bound / (seconds * expected / seen)


def idle_share(r) -> Optional[float]:
    """The share (%) of the traced window with no device operation running;
    None where the trace holds no device operation."""
    if r.trace is None or r.trace.window_s <= 0 or not r.trace.device:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)


def text_pad(texts: List[str]) -> int:
    """The padded text length the serving entry gives these texts (BPE ids,
    spaces as [SPACE], rounded up to 16)."""
    n = max(len(_tokenizer().encode(t.replace(" ", "[SPACE]")).ids) for t in texts)
    return -(-n // 16) * 16


@functools.lru_cache(maxsize=1)
def _tokenizer():
    from tokenizers import Tokenizer

    from portbench.check import ASSET

    return Tokenizer.from_file(str(ASSET))
