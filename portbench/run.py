"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: the cell's entry in
BENCHMARK.json and its file `portbench/workloads/<cell>.json` (the traffic
kind, its parameters and the limits of the correctness check), the
configuration's file named in BENCHMARK.json, the traffic kind's generator
`portbench/traffic/<kind>.py`, each per-layer metric's reader
`portbench/metrics/<metric>.py` and each kernel's work count
`portbench/roofline/<kernel>.py`. A new cell, traffic kind, metric or kernel
count is a new file and a new entry; no file here changes.

A run: set-up (the program built, weights and inputs made on the card from
the seed, the cell's shapes warmed up), then the measured window of
`--seconds`, then the correctness check against the plain reference in
portbench/reference/. With `--trace 0` the result line carries the cell's
end-to-end metrics; with `--trace 1` its per-layer metrics, read from the
window, from a few more units timed by stage and from a torch.profiler
session over a few more units after those.
The last line of standard output is one JSON object; the numbers compared
for `correct` end standard error and the result line (`checks`).
"""

from __future__ import annotations

import time

T_PROCESS = time.time()  # set-up is counted from here

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

PKG = pathlib.Path(__file__).resolve().parent
ROOT = PKG.parent
# top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "ttts_tpu")


class RunError(Exception):
    """A run that cannot report: the message goes to standard error."""


def forbidden_modules() -> list:
    """The forbidden top-level names (compared whole) among sys.modules."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & set(FORBIDDEN))


def _refuse_forbidden(when: str) -> None:
    found = forbidden_modules()
    if found:
        raise RunError(f"sys.modules holds {', '.join(found)} {when}")


def load(path: pathlib.Path, name: str) -> types.ModuleType:
    """The Python file at `path` as a module (file names may hold dots)."""
    if not path.is_file():
        raise RunError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: pathlib.Path) -> dict:
    if not path.is_file():
        raise RunError(f"no file {path}")
    return json.loads(path.read_text())


def find_cell(root: pathlib.Path, name: str) -> types.SimpleNamespace:
    """The cell `name` of root/BENCHMARK.json with its configuration and
    workload files, its end-to-end metrics and its per-layer metrics."""
    bench = read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise RunError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = configs[cell["config"]]
    workload = read_json(root / "portbench" / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if workload.get(key) != cell[key]:
            raise RunError(f"{name}: the workload file's {key} {workload.get(key)!r} is not "
                           f"BENCHMARK.json's {cell[key]!r}")
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in reported else [])]
    return types.SimpleNamespace(name=name, entry=cell, config=read_json(root / config["file"]),
                                 workload=workload, end_to_end=e2e, per_layer=layer)


def _cache_dirs(root: pathlib.Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout; no library
    may load JAX or Flax on the port's behalf."""
    build = root / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def card(chips: int, require: bool):
    """The device the run uses: the card, or (only where `require` is off,
    the CPU tests) the CPU when no card is present."""
    import torch

    if torch.cuda.is_available() and torch.cuda.device_count() >= chips:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return torch.device("cuda", 0)
    if require:
        raise RunError(f"needs {chips} CUDA device(s): torch.cuda.is_available() "
                       f"{torch.cuda.is_available()}, device_count "
                       f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    return torch.device("cpu")


def context(cell, seed: int, dev, trace: bool = False) -> types.SimpleNamespace:
    """What a traffic kind's functions share for one run: the seed, the
    device, the configuration file, the traffic's parameters and limits;
    the kind adds its own state (the program, the records' inputs)."""
    return types.SimpleNamespace(seed=seed, trace=trace, device=dev, cfg=cell.config,
                                 params=cell.workload["params"],
                                 limits=cell.workload.get("limits", {}))


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(argv=None, root: pathlib.Path = ROOT, require_card: bool = True) -> dict:
    """One run; returns the result line's object (printing is main's). The
    CPU tests pass `require_card` False to skip the look for a card."""
    ap = argparse.ArgumentParser(prog="portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = pathlib.Path(root)
    _cache_dirs(root)
    cell = find_cell(root, args.workload)
    dev = card(int(cell.entry["chips"]), require_card)
    import torch

    kind = load(PKG / "traffic" / f"{cell.workload['kind']}.py",
                f"portbench_traffic_{cell.workload['kind']}")
    ctx = context(cell, args.seed, dev, bool(args.trace))
    if dev.type == "cuda":
        _build_kernels()
    kind.setup(ctx)
    _sync(dev)
    _refuse_forbidden("after set-up")

    from portbench import counters

    before = counters.snapshot()
    # the measured window: units back to back until `seconds` have passed
    records = []
    t0 = time.perf_counter()
    setup_s = time.time() - T_PROCESS
    while time.perf_counter() - t0 < args.seconds or not records:
        records.append(kind.unit(ctx, len(records)))
    _sync(dev)
    window_s = time.perf_counter() - t0
    print(f"launches a unit: {counters.per_unit(before, counters.snapshot(), len(records))}",
          flush=True)

    staged, traced, trace = [], [], None
    if args.trace:
        staged = _staged_units(kind, ctx, len(records))
        traced, trace = _traced_units(kind, ctx, len(records) + len(staged))
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # frees the program's state, then runs the reference; a reading that is
    # not a finite number, or has no finite limit, is not correct
    checks = [(name, _finite(value), limit) for name, value, limit in kind.check(ctx, records)]
    correct = bool(checks) and all(v <= lim and math.isfinite(lim) for _, v, lim in checks)

    if args.trace:
        reader = types.SimpleNamespace(records=records, staged=staged, traced=traced,
                                       trace=trace, ctx=ctx, window_s=window_s,
                                       roofline=roofline, peaks=peaks())
        metrics = {}
        for m in cell.per_layer:
            value = load(PKG / "metrics" / f"{m['name']}.py",
                         f"portbench_metric_{m['name'].replace('.', '_')}").read(reader)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = kind.end_to_end(ctx, records, window_s)
        values["setup_s"] = setup_s
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}

    _refuse_forbidden("after the window")
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": int(cell.entry["chips"]), "memory_peak_bytes": int(memory_peak)}
    out = {"correct": correct, "attempted": sum(r["requests"] for r in records),
           "failed": sum(r.get("failed", 0) for r in records), "metrics": metrics,
           "device": device}
    if trace is not None:
        device.update(busy_s=trace.busy_s, window_s=trace.window_s)
        out["breakdown"] = {"device_ops": trace.by_name(), "idle_gaps": trace.idle_gaps()}
    out["checks"] = {name: {"value": value, "limit": _finite(limit)}
                     for name, value, limit in checks}
    return out


def _finite(x) -> float:
    """x as a float, with NaN and infinities read as 1e300 (JSON holds no others)."""
    x = float(x)
    return x if math.isfinite(x) else 1e300


def _build_kernels() -> None:
    """Build (a cold cache) or load the program's kernel library before the
    traffic's set-up, and say which on its own line: set-up includes it."""
    from ttts_tpu_torch.ops.cuda import _build

    cold = not _build.library_path().exists()
    t0 = time.time()
    _build.library()
    print(f"build_s: {time.time() - t0!r} ({'cold: built' if cold else 'warm: loaded'})",
          flush=True)


def _staged_units(kind, ctx, start: int) -> list:
    """`trace_units` more units with the kind's stage times on (each stage
    ends in a synchronise, so never in the window); none where the kind
    keeps no stage times."""
    if not hasattr(kind, "stage_times"):
        return []
    kind.stage_times(ctx, True)
    staged = [kind.unit(ctx, start + i) for i in range(int(ctx.params.get("trace_units", 2)))]
    kind.stage_times(ctx, False)
    stages = [r["stages"] for r in staged]
    print("stage ms, mean of the staged units: " + json.dumps(
        {k: 1e3 * sum(s[k] for s in stages) / len(stages) for k in stages[0]}), flush=True)
    return staged


def _traced_units(kind, ctx, start: int):
    """`trace_units` more units under torch.profiler, inside the host range
    the Trace reads as its window (ended by a synchronise)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench import trace as tr

    n = int(ctx.params.get("trace_units", 2))
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if ctx.device.type == "cuda"
                                     else [])
    traced = []
    with profile(activities=acts) as prof:
        with record_function(tr.WINDOW):
            for i in range(n):
                traced.append(kind.unit(ctx, start + i))
            _sync(ctx.device)
    return traced, tr.from_profiler(prof)


def peaks() -> dict:
    return read_json(PKG / "roofline" / "peaks.json")


def roofline(kernel: str) -> types.ModuleType:
    """The work count of `kernel` (portbench/roofline/<kernel>.py)."""
    return load(PKG / "roofline" / f"{kernel}.py", f"portbench_roofline_{kernel}")


def _fmt(x) -> str:
    return repr(float(x)) if isinstance(x, (int, float)) and math.isfinite(x) else str(x)


def main(argv=None) -> int:
    try:
        out = run(argv)
    except RunError as e:
        print(f"portbench: {e}", file=sys.stderr, flush=True)
        return 2
    for name, c in out["checks"].items():
        print(f"check {name}: {_fmt(c['value'])} (limit {_fmt(c['limit'])})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
