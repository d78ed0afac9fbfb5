"""The GPT flash route's causal forward (ttts_tpu_torch/csrc/attention_fwd.cu)
against the forward that route used before (the serving kernel's causal
mode with an lse buffer) and against other versions of attention_fwd.cu,
in turns on one CUDA card.

    python3 chip_flash_fwd.py [--parent FILE] [--other FILE ...] [--ptxas]

Builds the kernels of ttts_tpu_torch/csrc ("current") and, at once (one
nvcc per source), with --parent a copy of csrc whose attention.cu is FILE,
an attention.cu whose ttts_flash_attention still takes an lse buffer
("parent", launched by this script through its own C entry point), and
with each --other a copy whose attention_fwd.cu is that file ("other1",
...); --ptxas prints ptxas's register, shared-memory and wgmma report of
each build's attention_fwd.cu. Then, for the current build and each
other, O and lse2 against flash_causal_forward_plain and the backward fed
that O and lse2 against flash_causal_backward_plain (chip_smoke's
_flash_readings, limits ATTN_TOL, LSE_TOL, BWD_TOL) at every shape of
SHAPES (the edges of the 64-row warpgroups, the 128-key tiles and the
192-row blocks at D=64 and D=32, and the reference context at B=4), and two
forward calls on the same inputs bit-equal; the parent's O and lse2 against
the plain version at two shapes. At chip_smoke.FLASH_CTX
(B=64, T=1796, H=8, D=64) the builds are timed in turns (current, parent,
the others, the others again in reverse, parent, current), each turn as
torch.profiler's device time per call split by kernel
(chip_smoke.device_us) and the median of 20 calls between CUDA events
(chip_smoke.median_ms), with SDPA (is_causal) profiled three times between
the turns, beside the bound (chip_smoke._flash_bound). With --parent, the
serving kernel's four modes (attention.cu, whose lse store the current
build dropped) at phase (c)'s largest shapes (SERVING) are timed the same
way, current against parent in turns. The last line is one JSON object;
the exit code is 1 if a check of the current build fails.
Imports no JAX; needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import torch

import chip_smoke as c

EDGES = (1, 63, 64, 65, 127, 128, 129, 191, 192, 193, 255, 256, 257)
SHAPES = ([(2, t, 8, 64) for t in EDGES + (100, 164, 300)] + [(4, 1796, 8, 64)]
          + [(2, t, 4, 32) for t in EDGES])
# the serving kernel's modes at phase (c)'s largest shapes: (mode, (B, T, H,
# D), a bias strip, causal)
SERVING = (("bias", (2, 1600, 16, 32), True, False), ("nobias", (4, 400, 16, 64), False, False),
           ("causal", (1, 436, 8, 64), False, True), ("bias_causal", (1, 163, 8, 64), True, True))
# the parent's ttts_flash_attention: q, k, v, strip, out, lse, B, T, H, D,
# six strides, the strip's stride, causal, scale, stream
PARENT_SIGNATURE = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 12 + (ctypes.c_float,
                                                                    ctypes.c_void_p)


def _use(csrc) -> None:
    from ttts_tpu_torch.ops.cuda import _build

    _build.CSRC = csrc
    _build.library.cache_clear()


def _parent_attention(lib, q, k, v, strip=None, causal=True, lse=True):
    """The parent's attention kernel: by default its causal mode with an lse
    buffer, the route's forward → (O, lse2); else a serving mode → O."""
    from ttts_tpu_torch.ops.cuda.attention import _strides

    b, t, h, d = q.shape
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    stats = torch.empty((b, h, t), dtype=torch.float32, device=q.device) if lse else None
    err = lib.ttts_flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   None if strip is None else strip.data_ptr(), out.data_ptr(),
                                   None if stats is None else stats.data_ptr(), b, t, h, d,
                                   *_strides(q, "q"), *_strides(k, "k"), *_strides(v, "v"),
                                   0 if strip is None else strip.stride(0), int(causal),
                                   1.0 / math.sqrt(d), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the parent's ttts_flash_attention: CUDA error {err}")
    return (out, stats) if lse else out


def _serving_turns(lib, g) -> dict:
    """Device us of each serving mode at its SERVING shape, current build
    against the parent's, in turns (current, parent, parent, current); each
    on strided q/k/v views of one fused tensor and, with a bias, an (H,
    2T - 1) strip, as phase (c) holds them."""
    from ttts_tpu_torch.ops.cuda.attention import flash_attention

    out = {}
    for mode, (b, t, h, d), bias, causal in SERVING:
        qkv = torch.randn(b, t, h, 3 * d, generator=g, device="cuda").to(torch.bfloat16)
        q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
        strip = torch.randn(h, 2 * t - 1, generator=g, device="cuda") if bias else None
        runs = {"current": partial(flash_attention, q, k, v, strip, causal),
                "parent": partial(_parent_attention, lib, q, k, v, strip, causal, False)}
        same = torch.equal(runs["current"](), runs["parent"]())
        turns = [(name, c.device_us(runs[name])) for name in ("current", "parent", "parent",
                                                              "current")]
        out[mode] = {"shape": "B=%d T=%d H=%d D=%d" % (b, t, h, d), "outputs_equal": same,
                     "turns": [{"build": n, "device_us": c.device_total_us(x), "device": x}
                               for n, x in turns]}
        c.log(f"serving {mode} {out[mode]['shape']}: outputs equal {same}; " + "; ".join(
            f"{n} {x}" for n, x in turns))
    return out


def _ptxas(csrc) -> str:
    """ptxas's register, shared-memory, spill and wgmma report of
    csrc/attention_fwd.cu."""
    from ttts_tpu_torch.ops.cuda import _build

    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas=-v", "-c", "-o",
                          os.devnull, str(csrc / "attention_fwd.cu")],
                         capture_output=True, text=True)
    return res.stderr


def _check(g) -> tuple:
    """({shape: {o, lse, dq, dk, dv: reading}}, bad readings, two forward
    calls bit-equal) of the loaded build."""
    from ttts_tpu_torch.ops.cuda.attention import flash_causal_forward

    limits = {"o": ("rel_l2", c.ATTN_TOL), "lse": ("max_abs", c.LSE_TOL),
              **{n: ("rel_l2", c.BWD_TOL) for n in ("dq", "dk", "dv")}}
    readings, bad = {}, []
    for shape in SHAPES:
        m = c._flash_readings(shape, g)
        key = "B=%d T=%d H=%d D=%d" % shape
        readings[key] = {n: m[n][metric] for n, (metric, _) in limits.items()}
        bad += [(key, n) for n, (metric, tol) in limits.items() if not m[n][metric] <= tol]
    same = True
    for shape in ((2, 300, 8, 64), (2, 257, 4, 32)):
        _, (q, k, v, _) = c._flash_inputs(g, *shape)
        (o1, l1), (o2, l2) = flash_causal_forward(q, k, v), flash_causal_forward(q, k, v)
        same = same and torch.equal(o1, o2) and torch.equal(l1, l2)
    return readings, bad, same


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an attention.cu whose ttts_flash_attention takes an lse "
                    "buffer (the route's forward before attention_fwd.cu)")
    ap.add_argument("--other", action="append", default=[],
                    help="another attention_fwd.cu, built beside the current one")
    ap.add_argument("--ptxas", action="store_true", help="print ptxas's report of each "
                    "build's attention_fwd.cu")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_flash_fwd: no CUDA device", file=sys.stderr)
        return 1
    from ttts_tpu_torch.ops.cuda import _build
    from ttts_tpu_torch.ops.cuda.attention import flash_causal_forward, flash_causal_forward_plain

    card = c.phase_card()
    builds = {"current": _build.CSRC}
    copies = ([("parent", "attention.cu", args.parent)] if args.parent else []) + [
        (f"other{i + 1}", "attention_fwd.cu", f) for i, f in enumerate(args.other)]
    for name, file, src in copies:
        d = _build.BUILD_DIR.parent / f"fwd_{name}_csrc"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        shutil.copy(src, d / file)
        builds[name] = d
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        libs = dict(zip(builds, pool.map(lambda d: _build.build(csrc=d), builds.values())))
        build_s = time.perf_counter() - t0
        if args.ptxas:
            reports = pool.map(_ptxas, [builds[n] for n in builds if n != "parent"])
            for name, report in zip([n for n in builds if n != "parent"], reports):
                print(f"{name}: attention_fwd.cu, ptxas:\n{report}", flush=True)
    c.log(f"built {len(builds)} copies of csrc at once in {build_s:.1f} s: " + ", ".join(
        f"{name} {libs[name].name}" for name in builds))

    g = torch.Generator("cuda").manual_seed(23)
    out = {"card": card, "build_s": build_s, "tol": {"o": c.ATTN_TOL, "lse": c.LSE_TOL,
                                                     "bwd": c.BWD_TOL}, "checks": {}}
    failed = []
    runs = {}
    b, t, h, d = c.FLASH_CTX
    _, (q, k, v, _) = c._flash_inputs(g, b, t, h, d)
    for name, csrc in builds.items():
        if name == "parent":
            lib = ctypes.CDLL(str(libs[name]))
            lib.ttts_flash_attention.argtypes = PARENT_SIGNATURE
            lib.ttts_flash_attention.restype = ctypes.c_int
            parent = {}
            for shape in ((2, 164, 8, 64), (4, 1796, 8, 64)):
                _, (qp, kp, vp, _) = c._flash_inputs(g, *shape)
                (o, lse), (o_p, lse_p) = (_parent_attention(lib, qp, kp, vp),
                                          flash_causal_forward_plain(qp, kp, vp))
                parent["B=%d T=%d H=%d D=%d" % shape] = {
                    "o": c.compare(o, o_p)["rel_l2"], "lse": c.compare(lse, lse_p)["max_abs"]}
            out["checks"][name] = parent
            c.log(f"parent: {parent}")
            runs[name] = partial(_parent_attention, lib, q, k, v)
            parent_lib = lib
            continue
        _use(csrc)
        readings, bad, same = _check(g)
        worst = {n: max(r[n] for r in readings.values()) for n in ("o", "lse", "dq", "dk", "dv")}
        out["checks"][name] = {"worst": worst, "bad": bad, "repeats_bit_equal": same,
                               "readings": readings}
        c.log(f"{name}: worst over {len(SHAPES)} shapes {worst} (tol o {c.ATTN_TOL}, lse "
              f"{c.LSE_TOL}, dq/dk/dv {c.BWD_TOL}), beyond a limit {bad or 'none'}, two "
              f"forward calls bit-equal {same}: " + "; ".join(
                  f"{s} " + " ".join(f"{n} {x:.2e}" for n, x in r.items())
                  for s, r in readings.items()))
        if name == "current" and (bad or not same):
            failed.append(name)
        runs[name] = partial(flash_causal_forward, q, k, v)

    others = [n for n in builds if n.startswith("other")]
    order = (["current"] + (["parent"] if "parent" in builds else []) + others
             + others[::-1] + (["parent"] if "parent" in builds else []) + ["current"])
    sdpa = partial(torch.nn.functional.scaled_dot_product_attention,
                   *(z.transpose(1, 2) for z in (q, k, v)), is_causal=True)
    library_at = {0, len(order) // 2 - 1, len(order) - 2}
    turns, library = [], []
    for i, name in enumerate(order):
        if name != "parent":
            _use(builds[name])
        dev = c.device_us(runs[name])
        turns.append({"build": name, "device_us": c.device_total_us(dev), "device": dev,
                      "event_ms": c.median_ms(runs[name])})
        c.log(f"turn {i + 1}, {name}: {dev}; events {turns[-1]['event_ms']:.4f} ms")
        if i in library_at:
            dev = c.device_us(sdpa)
            library.append({"device_us": c.device_total_us(dev), "device": dev,
                            "event_ms": c.median_ms(sdpa)})
            c.log(f"SDPA (is_causal), run {len(library)}: {dev}; events "
                  f"{library[-1]['event_ms']:.4f} ms")
    bms, by = c._flash_bound(b, t, h, d, False)
    out.update({"shape": f"B={b} T={t} H={h} D={d} bf16", "bound_ms": bms, "bound_by": by,
                "turns": turns, "sdpa": library})
    c.log(f"bound {bms:.4f} ms ({by}) | card {card}")
    _use(builds["current"])
    if "parent" in builds:
        out["serving"] = _serving_turns(parent_lib, g)
    for name, csrc in builds.items():
        if name != "current":
            shutil.rmtree(csrc, ignore_errors=True)
    print(json.dumps(out))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
