"""A serving cell's rate against its batch, on the card, in one process:
the cell's set-up at each texts_per_call in turn, then calls back to back.

    python3 -m portbench.sweep --workload <name> --seed <n> --texts 16,64,128 [--calls 3]

Each batch prints one JSON line: texts a call, seconds a call, audio
seconds a second, the stage times of one more call, the memory peak. This
is how a serving cell's texts_per_call is chosen (PERF.md); the
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from portbench import run as bench


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--texts", required=True)
    ap.add_argument("--calls", type=int, default=3)
    args = ap.parse_args(argv)
    bench._cache_dirs(bench.ROOT)
    cell = bench.find_cell(bench.ROOT, args.workload)
    dev = bench.card(int(cell.entry["chips"]), True)
    import torch

    kind = bench.load(bench.PKG / "traffic" / f"{cell.workload['kind']}.py", "portbench_kind")
    torch.cuda.init()
    for n in [int(x) for x in args.texts.split(",") if x]:
        ctx = bench.context(cell, args.seed, dev)
        ctx.params = dict(ctx.params, texts_per_call=n)
        torch.cuda.reset_peak_memory_stats(dev)
        try:
            t0 = time.perf_counter()
            kind.setup(ctx)
            torch.cuda.synchronize(dev)
            setup_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            records = [kind.unit(ctx, i) for i in range(args.calls)]
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            kind.stage_times(ctx, True)
            stages = kind.unit(ctx, args.calls)["stages"]
        except torch.cuda.OutOfMemoryError as e:
            print(json.dumps({"texts": n, "out_of_memory": str(e)[:200]}), flush=True)
            break
        print(json.dumps({"texts": n, "setup_s": setup_s, "call_s": wall / args.calls,
                          "audio_s_per_s": sum(r["audio_s"] for r in records) / wall,
                          "stage_ms": {k: 1e3 * v for k, v in stages.items()},
                          "memory_peak_bytes": torch.cuda.max_memory_allocated(dev)}),
              flush=True)
        for h in ctx.hooks:
            h.remove()
        del ctx, records
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
