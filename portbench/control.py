"""Readings for the limits of the correctness check, on the card, in one
process: the program's numbers over many seeds, the control's (the plain
reference lowered to fp8 in the program's place) over a few, and, for a
training cell, the program with half of each batch left out.

    python3 -m portbench.control --workload <name> --seeds 1,2,3 \
        [--control 4,5,6] [--half-batch 7,8,9] [--units 2]

Each seed prints one JSON line {"seed", "what", readings}. The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench import run as bench


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--half-batch", default="")
    ap.add_argument("--units", type=int, default=2)
    args = ap.parse_args(argv)
    bench._cache_dirs(bench.ROOT)
    cell = bench.find_cell(bench.ROOT, args.workload)
    dev = bench.card(int(cell.entry["chips"]), True)
    kind = bench.load(bench.PKG / "traffic" / f"{cell.workload['kind']}.py", "portbench_kind")
    seeds = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    plan = ([(s, "program") for s in seeds(args.seeds)]
            + [(s, "control") for s in seeds(args.control)]
            + [(s, "half_batch") for s in seeds(args.half_batch)])
    for seed, what in plan:
        ctx = bench.context(cell, seed, dev)
        if what == "half_batch":
            _run_half(kind, ctx)
        else:
            kind.setup(ctx)
        records = [kind.unit(ctx, i) for i in range(args.units)]
        if what == "control":
            readings = kind.control(ctx, records)
        else:
            readings = {name: value for name, value, _ in kind.check(ctx, records)}
        print(json.dumps({"seed": seed, "what": what, "readings": readings}), flush=True)
        del ctx
        if dev.type == "cuda":
            import torch

            torch.cuda.empty_cache()
    return 0


def _run_half(kind, ctx) -> None:
    """kind.setup with its train step given only the first half of each
    batch's rows, from the first step on (the mean is then taken over the
    rest)."""
    import ttts_tpu_torch.train.steps as steps

    full = steps.gpt_train_step

    def half(state, batch, key, **kw):
        b = batch["text"].shape[0] // 2
        return full(state, {k: v[:b] for k, v in batch.items()}, key, **kw)

    steps.gpt_train_step = half
    try:
        kind.setup(ctx)
    finally:
        steps.gpt_train_step = full


if __name__ == "__main__":
    sys.exit(main())
