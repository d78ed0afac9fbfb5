"""Variants of the VQ and fused GroupNorm -> qkv kernels on one CUDA card.

    python3 chip_variants.py [round ...]

Each variant is a copy of ttts_tpu_torch/csrc with a few text edits
(VARIANTS: round -> name -> edits; "base" has none of its own), built at once with
the copies of its round, then measured in a process of its own (a variant
that traps loses only its own CUDA context): VQ at N=500, 33 and 1 with
bins=1024, N=500 with bins=1000 and N=500 at D=32, and gn_qkv at (B, T) =
(4, 1600), (2, 1024), (1, 65), C=512, each as its error against the plain
version and chip_smoke.device_us, the torch.profiler device time per call
split by launch. Then the floors: VQ's x @ cb.T alone (f32, TF32 off) and
gn_qkv's 6400x512x1536 bf16 product alone, through cuBLAS. One JSON object
per variant. Rounds: 1, 2 (default: both). Rounds 1 and 2 measured the
first VQ design, 32-row tiles of 4 x 8 codes a thread (VQ32, applied first
to every variant of theirs); "r40" of round 2 is the kernel as it stands.
Some variants change what a kernel computes (marked "timing only"): their
errors are not a check.
Imports no JAX; needs a CUDA card and nvcc.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

import chip_smoke as c

VQ32 = (("vq.cu", "constexpr int VQ_ROWS = 40;", "constexpr int VQ_ROWS = 32;"),
        ("vq.cu", "VQ_MR = 5, VQ_MC = 8;", "VQ_MR = 4, VQ_MC = 8;"))
VQ_STAGES6 = ("vq.cu", "constexpr int VQ_STAGES = 3;", "constexpr int VQ_STAGES = 6;")
VQ_4X4 = ("vq.cu", "VQ_MR = 4, VQ_MC = 8;", "VQ_MR = 4, VQ_MC = 4;")
VQ_ROWS40 = (("vq.cu", "constexpr int VQ_ROWS = 32;", "constexpr int VQ_ROWS = 40;"),
             ("vq.cu", "VQ_MR = 4, VQ_MC = 8;", "VQ_MR = 5, VQ_MC = 8;"))
VQ_ROWS48 = (("vq.cu", "constexpr int VQ_ROWS = 32;", "constexpr int VQ_ROWS = 48;"),
             ("vq.cu", "VQ_MR = 4, VQ_MC = 8;", "VQ_MR = 6, VQ_MC = 8;"))
ROUNDS = {
    1: {
        "base": (),
        # VQ: the whole of D in flight (no ring refill; 121 KB, one block an
        # SM); gn_qkv: a 5-stage ring
        "vst6_gst5": (VQ_STAGES6,
                      ("resblock.cu", "constexpr int QKV_STAGES = 4;",
                       "constexpr int QKV_STAGES = 5;")),
        # VQ: 256 threads of 4 x 4; gn_qkv: raw x into wgmma (timing only)
        "v44_gnoaff": (VQ_4X4,
                       ("resblock.cu",
                        "  return pack_bf16(fmaf(__uint_as_float(x2 << 16), m0, a0),\n"
                        "                   fmaf(__uint_as_float(x2 & 0xffff0000u), m1, a1));",
                        "  return x2;")),
        # gn_qkv: W alone loaded, A never fetched (timing only)
        "v44st6_gnoA": (VQ_4X4, VQ_STAGES6,
                        ("resblock.cu",
                         "          mbar_expect_tx(full, RB_STAGE);\n"
                         "          tma_load_3d(sa, &tx, full, kt * RB_BK, m0, b);",
                         "          mbar_expect_tx(full, RB_B_BYTES);")),
        "v28": (("vq.cu", "VQ_MR = 4, VQ_MC = 8;", "VQ_MR = 2, VQ_MC = 8;"),),
    },
    2: {
        "base": (),
        # VQ: 40-row tiles (13 clusters at N=500); gn_qkv: the table read
        # replaced by constants (timing only)
        "r40": VQ_ROWS40 + (("resblock.cu", "const float4 lo = s_ma[p], hi = s_ma[p + 4];",
                             "const float4 lo = make_float4(1.f, 1.f, 0.f, 0.f), hi = lo;"),),
        "r40s6": VQ_ROWS40 + (VQ_STAGES6,),
        # VQ: 48-row tiles (11 clusters); gn_qkv: each k-step's MMAs waited
        # for before the next A is built
        "r48": VQ_ROWS48 + (("resblock.cu",
                             "      wg_wait_one();  // step kt-1's MMAs are done: its stage and A "
                             "registers are free", "      wg_wait_all();"),),
        # gn_qkv: the output stores dropped (timing only)
        "r48s6": VQ_ROWS48 + (VQ_STAGES6,
                              ("resblock.cu",
                               "*reinterpret_cast<uint4*>(dst + ((size_t)b * T + row0 + r) * N + n0 "
                               "+ chunk * 8) = v;", "(void)v;")),
        "s4": (("vq.cu", "constexpr int VQ_STAGES = 3;", "constexpr int VQ_STAGES = 4;"),),
    },
}
VARIANTS = {r: {name: VQ32 + edits for name, edits in vs.items()} for r, vs in ROUNDS.items()}


def _csrc(round_: int, name: str):
    from ttts_tpu_torch.ops.cuda import _build

    return _build.BUILD_DIR.parent / f"variant_{round_}_{name}"


def measure(round_: int, name: str) -> None:
    """Errors and device times of one built variant (in its own process)."""
    from ttts_tpu_torch.ops.cuda import _build
    from ttts_tpu_torch.ops.cuda.resblock import fused_gn_qkv_plain

    _build.CSRC = _csrc(round_, name)
    c.phase_card()
    g = torch.Generator("cuda").manual_seed(3)
    vq, qkv = c.wrapper("vq_nearest"), c.wrapper("gn_qkv")
    out = {}
    for n, d, bins in ((500, 192, 1024), (33, 192, 1024), (500, 192, 1000), (1, 192, 1024),
                       (500, 32, 1024)):
        cb = torch.randn(bins, d, generator=g, device="cuda")
        cb[7] = cb[3]
        x = torch.randn(n, d, generator=g, device="cuda")
        x[0] = cb[3]
        wrong = c._vq_reading(x, cb, vq(x, cb))["wrong"] if d == 192 else "-"
        out[f"vq N={n} D={d} bins={bins}"] = f"wrong {wrong} | {c.device_us(lambda: vq(x, cb))}"
    for b, t in ((4, 1600), (2, 1024), (1, 65)):
        args = c._gn_qkv_args(g, b, t, 512, 0.5, 1.5)
        m = c.compare(qkv(*args), fused_gn_qkv_plain(*args))
        out[f"gn_qkv B={b} T={t}"] = f"excess {m['excess']:.3e} | {c.device_us(lambda: qkv(*args))}"
    print(json.dumps({f"round {round_}, {name}": out}, indent=1), flush=True)


def main(rounds) -> int:
    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device", file=sys.stderr)
        return 1
    from ttts_tpu_torch.ops.cuda import _build

    todo = [(r, name, edits) for r in rounds for name, edits in VARIANTS[r].items()]
    for r, name, edits in todo:
        d = _csrc(r, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        for file, old, new in edits:
            text = (d / file).read_text()
            if text.count(old) != 1:
                raise AssertionError(f"{name}: {old!r} not found once in {file}")
            (d / file).write_text(text.replace(old, new))
    # identical sources (one round's "base" and another's) share one library:
    # build each once, or two threads would write the same file
    first = {}
    for r, name, edits in todo:
        first.setdefault(edits, (r, name))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(first)) as pool:
        list(pool.map(lambda v: _build.build(csrc=_csrc(*v)), first.values()))
    print(f"built {len(first)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    failed = 0
    for r, name, _ in todo:
        res = subprocess.run([sys.executable, __file__, "--measure", str(r), name],
                             capture_output=True, text=True, timeout=300)
        print(res.stdout, flush=True)
        if res.returncode:
            failed += 1
            print(f"round {r}, {name}: exit {res.returncode}\n{res.stderr[-2000:]}", flush=True)
        shutil.rmtree(_csrc(r, name), ignore_errors=True)
    c.phase_card()  # TF32 off
    g = torch.Generator("cuda").manual_seed(7)
    xv, cbv = (torch.randn(*s, generator=g, device="cuda") for s in ((500, 192), (1024, 192)))
    qa, qw = (torch.randn(*s, generator=g, device="cuda").to(torch.bfloat16)
              for s in ((6400, 512), (512, 1536)))
    print(f"floor, VQ's x @ cb.T alone (f32): {c.device_us(lambda: xv @ cbv.T)}")
    print(f"floor, gn_qkv's 6400x512x1536 bf16 product alone: {c.device_us(lambda: qa @ qw)}")
    return 1 if failed else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--measure"]:
        measure(int(sys.argv[2]), sys.argv[3])
        sys.exit(0)
    sys.exit(main([int(a) for a in sys.argv[1:]] or sorted(VARIANTS)))
