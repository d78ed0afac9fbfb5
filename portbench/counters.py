"""The program's own launch counters (`ttts_tpu_torch.ops.cuda.*` wrappers'
`launches`), read before and after the window: the launches of each kernel
a unit (call or step), printed on an earlier line of the run's output."""

from __future__ import annotations

from typing import Dict

WRAPPERS = (("vq", "vq_nearest"), ("decode_attention", "decode_attention"),
            ("attention", "flash_attention"), ("resblock", "fused_scale_shift_resblock"),
            ("resblock", "fused_gn_qkv"))


def snapshot() -> Dict[str, int]:
    """{kernel (mode): launches so far} of every wrapper the program has."""
    import importlib

    out = {}
    for mod, fn in WRAPPERS:
        count = getattr(getattr(importlib.import_module(f"ttts_tpu_torch.ops.cuda.{mod}"), fn,
                                None), "launches", None)
        if isinstance(count, dict):
            out.update({f"{fn}.{mode}": int(n) for mode, n in count.items()})
        elif count is not None:
            out[fn] = int(count)
    return out


def per_unit(before: Dict[str, int], after: Dict[str, int], units: int) -> Dict[str, float]:
    """The launches a unit between two snapshots, the kernels that launched."""
    return {k: (after[k] - before.get(k, 0)) / max(units, 1) for k in after
            if after[k] > before.get(k, 0)}
