"""The GPT flash route's causal backward (ttts_tpu_torch/csrc/attention_bwd.cu)
against another version of that file, in turns on one CUDA card.

    python3 chip_flash_bwd.py [--other FILE] [--ptxas]

Builds the kernels of ttts_tpu_torch/csrc ("current") and, with --other, of
a copy of csrc whose attention_bwd.cu is FILE ("other"), at once (one nvcc
per source); --ptxas prints ptxas's register, shared-memory and wgmma report
of the current build's attention_bwd.cu. Then, for each build, the backward
against its plain version (flash_causal_backward_plain) at every shape of
SHAPES (the edges of the 64-row walked tiles and of the 128- and 192-row
blocks at D=64 and D=32, and the reference context at B=4), dq, dk and dv's rel_l2 beside chip_smoke.BWD_TOL
(the denominator floored as in phase (p)), and two calls on the same inputs
bit-equal. At chip_smoke.FLASH_CTX (B=64, T=1796, H=8, D=64) the builds are
timed in turns (current, other, other, current; without --other: current
twice), each turn as torch.profiler's device time per call split by kernel
(chip_smoke.device_us) and the median of 20 calls between CUDA events
(chip_smoke.median_ms), with SDPA's backward (autograd.grad of its kept
graph, as in phase (p)) profiled three times between the turns, beside the
bound (chip_smoke._flash_bound). The last line is one JSON object; the exit
code is 1 if the current build misses a limit or does not repeat.
Imports no JAX; needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import shutil
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import torch

import chip_smoke as c

SHAPES = ([(2, t, 8, 64) for t in (1, 63, 64, 65, 100, 127, 128, 129, 164, 191, 192, 193, 257)]
          + [(4, 1796, 8, 64)] + [(2, t, 4, 32) for t in (64, 127, 128, 129, 193, 257)])


def _use(csrc) -> None:
    from ttts_tpu_torch.ops.cuda import _build

    _build.CSRC = csrc
    _build.library.cache_clear()


def _check(g) -> tuple:
    """({shape: {dq, dk, dv: rel_l2}}, two calls bit-equal) of the loaded build."""
    from ttts_tpu_torch.ops.cuda.attention import flash_causal_backward, flash_causal_forward

    readings = {}
    for shape in SHAPES:
        m = c._flash_readings(shape, g)
        readings["B=%d T=%d H=%d D=%d" % shape] = {n: m[n]["rel_l2"] for n in ("dq", "dk", "dv")}
    _, (q, k, v, do) = c._flash_inputs(g, 2, 300, 8, 64)
    o, lse = flash_causal_forward(q, k, v)
    same = torch.equal(flash_causal_backward(q, k, v, o, lse, do),
                       flash_causal_backward(q, k, v, o, lse, do))
    return readings, same


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="another attention_bwd.cu, built beside the current one")
    ap.add_argument("--ptxas", action="store_true", help="print ptxas's report of the current "
                    "attention_bwd.cu")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_flash_bwd: no CUDA device", file=sys.stderr)
        return 1
    from ttts_tpu_torch.ops.cuda import _build
    from ttts_tpu_torch.ops.cuda.attention import flash_causal_backward, flash_causal_forward

    card = c.phase_card()
    builds = {"current": _build.CSRC}
    if args.other:
        other = _build.BUILD_DIR.parent / "other_csrc"
        shutil.rmtree(other, ignore_errors=True)
        shutil.copytree(_build.CSRC, other)
        shutil.copy(args.other, other / "attention_bwd.cu")
        builds["other"] = other
    report = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(report), ThreadPoolExecutor(len(builds)) as pool:
            list(pool.map(lambda kv: _build.build(verbose=args.ptxas and kv[0] == "current",
                                                  csrc=kv[1]), builds.items()))
    finally:
        if args.ptxas:  # the build prints each source's report under "<name>.cu:"
            parts = re.split(r"^(\S+\.cu):$", report.getvalue(), flags=re.M)
            print("attention_bwd.cu:" + dict(zip(parts[1::2], parts[2::2])).get(
                "attention_bwd.cu", " no report"), flush=True)
    build_s = time.perf_counter() - t0
    c.log(f"built {len(builds)} copies of csrc at once in {build_s:.1f} s")

    g = torch.Generator("cuda").manual_seed(21)
    out = {"card": card, "build_s": build_s, "bwd_tol": c.BWD_TOL, "checks": {}}
    failed = []
    for name, csrc in builds.items():
        _use(csrc)
        readings, same = _check(g)
        worst = max(max(r.values()) for r in readings.values())
        out["checks"][name] = {"worst_rel_l2": worst, "repeats_bit_equal": same,
                               "readings": readings}
        c.log(f"{name}: worst rel_l2 {worst:.3e} (tol {c.BWD_TOL}) over {len(SHAPES)} shapes, "
              f"two calls bit-equal {same}: " + "; ".join(
                  f"{s} " + " ".join(f"{n} {x:.2e}" for n, x in r.items())
                  for s, r in readings.items()))
        if name == "current" and not (worst <= c.BWD_TOL and same):
            failed.append(name)

    b, t, h, d = c.FLASH_CTX
    _, (q, k, v, do) = c._flash_inputs(g, b, t, h, d)
    _use(builds["current"])
    o, lse = flash_causal_forward(q, k, v)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt, dot = (z.transpose(1, 2) for z in (q, k, v, do))
    qg, kg, vg = (z.detach().requires_grad_() for z in (qt, kt, vt))
    y = sdpa(qg, kg, vg, is_causal=True)

    def sdpa_bwd():
        return torch.autograd.grad(y, (qg, kg, vg), dot, retain_graph=True)

    order = ["current", "other", "other", "current"] if args.other else ["current", "current"]
    turns, library = [], []
    for i, name in enumerate(order):
        _use(builds[name])
        run = partial(flash_causal_backward, q, k, v, o, lse, do)
        dev = c.device_us(run)
        turns.append({"build": name, "device_us": c.device_total_us(dev), "device": dev,
                      "event_ms": c.median_ms(run)})
        c.log(f"turn {i + 1}, {name}: {dev}; events {turns[-1]['event_ms']:.4f} ms")
        if i < 3:  # SDPA between the turns
            library.append(c.device_us(sdpa_bwd))
            c.log(f"SDPA's backward, run {len(library)}: {library[-1]}")
    while len(library) < 3:
        library.append(c.device_us(sdpa_bwd))
        c.log(f"SDPA's backward, run {len(library)}: {library[-1]}")
    bms, by = c._flash_bound(b, t, h, d, True)
    out.update({"shape": f"B={b} T={t} H={h} D={d} bf16", "bound_ms": bms, "bound_by": by,
                "turns": turns, "sdpa_backward": [{"device_us": c.device_total_us(x), "device": x}
                                                  for x in library]})
    c.log(f"bound {bms:.4f} ms ({by}) | card {card}")
    _build.CSRC = builds["current"]
    if "other" in builds:
        shutil.rmtree(builds["other"], ignore_errors=True)
    print(json.dumps(out))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
