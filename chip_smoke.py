"""Chip smoke test of the PyTorch / CUDA port (ttts_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one printed line each, any failure raising (non-zero exit):
  (a) the card (nvidia-smi name and power limit), torch and CUDA versions;
  (b) build the hand-written kernels from ttts_tpu_torch/csrc with nvcc;
  (c) each kernel against its plain PyTorch version at the serving path's
      full-width shapes, in the working dtype: errors against the stated
      tolerance (relative: see compare and the *_TOL constants), and the
      median time of both from CUDA events;
  (d) end to end: TextToSpeech(default_config(), device="cuda") on random
      seeded weights (attention output projections made non-zero, since they
      are zero-initialised and would hide a wrong attention kernel), a seeded
      5 s 44.1 kHz synthetic voice and a pinyin text, `tts(...,
      preset="ultra_fast", max_generate_length=400)` twice. Checks a finite
      waveform of the length the code length implies, and that every kernel
      was launched by the end-to-end calls;
  (e) the card's path against the port's f32 CPU path (which tests/
      test_torch_*.py hold to the JAX package) at the same full width and
      weights, on a small input, stage by stage from shared inputs: prompt
      codes equal, GPT prefill + teacher-forced decode logits, and the
      latent → diffusion (10 steps, shared noise) → Vocos tail, each within
      a stated relative L2 error (the card runs the GPT and diffusion in bf16);
  (f) torch.profiler device time of each kernel and its plain version, and
      the device's busy share of a steady tts call.
The last two lines are the kernel table as JSON and then
{"ok": true, "device": {...}}. Imports no JAX; needs a CUDA card.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

KERNELS = {
    # name: (module, wrapper, source, replaced TPU kernel)
    "vq_nearest": ("vq", "vq_nearest", "ttts_tpu_torch/csrc/vq.cu",
                   "ttts_tpu/ops/pallas/vq.py:76"),
    "decode_attention": ("decode_attention", "decode_attention",
                         "ttts_tpu_torch/csrc/decode_attention.cu",
                         "ttts_tpu/ops/pallas/decode_attention.py:180"),
    "flash_bias_attention": ("attention", "flash_attention",
                             "ttts_tpu_torch/csrc/attention.cu",
                             "ttts_tpu/ops/pallas/attention.py:169"),
    "scale_shift_resblock": ("resblock", "fused_scale_shift_resblock",
                             "ttts_tpu_torch/csrc/resblock.cu",
                             "ttts_tpu/ops/pallas/resblock.py:142"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def wrapper(name: str):
    import importlib

    mod, fn, _, _ = KERNELS[name]
    return getattr(importlib.import_module(f"ttts_tpu_torch.ops.cuda.{mod}"), fn)


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# ----------------------------------------------------------------- (a), (b)


def phase_card() -> str:
    # cuDNN defaults to TF32 for f32 convolutions; the codec feeds the VQ argmin
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"(a) card: {card} | torch {torch.__version__} | CUDA {torch.version.cuda}"
        f" | {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return card


def phase_build(verbose: bool = False) -> float:
    from ttts_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    _build.build(verbose=verbose)
    _build.library()
    secs = time.perf_counter() - t0
    log(f"(b) build: {secs:.2f} s (nvcc {_build.last_build_seconds:.2f} s) -> "
        f"{_build.library_path().name}")
    return secs


# ---------------------------------------------------------------------- (c)

# Tolerances, each on the metric named beside it (see compare). Measured on
# an H100 80GB HBM3 (700 W), the correct kernels read, and a copy with one
# planted fault read (PERF.md, Findings):
#   decode:    excess <= 1e-5 against the plain version on f32 copies of the
#              inputs, i.e. within the bf16 rounding of the output: correct
#              at most -4e-8; the first 32-row chunk dropped, 0.32;
#   attention: rel_l2 <= 5e-3 against the bf16 plain version (the kernel
#              rounds P to bf16 before P.V): correct 1.9e-3 to 2.2e-3; the
#              ragged-edge key mask removed, 0.16 at T=94;
#   resblock:  excess <= 1e-3 against the bf16 plain version: correct
#              1.6e-4 to 4.7e-4; the conv3 'SAME' padding applied before the
#              activation, 2.5e-2.
DECODE_TOL, ATTN_TOL, RES_TOL = 1e-5, 5e-3, 1e-3
BF16_STEP = 2.0 ** -7  # a bf16 rounding step, relative to the rounded value


def compare(got: torch.Tensor, want: torch.Tensor) -> dict:
    """max_abs; rel_l2 = |got - want|_2 / |want|_2; excess = the largest
    error beyond one bf16 rounding step of the reference value, over
    max|want|: max(|got - want| - 2^-7 |want|) / max|want|."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    scale = float(want.abs().max())
    return {"max_abs": float(err.max()),
            "rel_l2": float((got - want).norm() / want.norm()),
            "excess": float((err - BF16_STEP * want.abs()).max()) / scale}


def _timed(rows, name, shape, m, metric, tol, run, run_plain):
    ms, pms = median_ms(run), median_ms(run_plain)
    log(f"(c) {name} {shape}: max_abs_err {m['max_abs']:.3e}, rel_l2 {m['rel_l2']:.3e}, "
        f"excess {m['excess']:.3e} (tol: {metric} <= {tol}) | kernel {ms:.4f} ms, "
        f"plain {pms:.4f} ms")
    rows.append({"name": name, "max_abs_err": m["max_abs"], "ms": ms, "plain_ms": pms,
                 "run": run, "run_plain": run_plain})
    if not m[metric] <= tol:
        raise AssertionError(f"{name} {shape}: {metric} {m[metric]:.3e} > {tol}")


def _check_vq(g, rows):
    from ttts_tpu_torch.ops.cuda.vq import vq_nearest_plain

    fn = wrapper("vq_nearest")
    for n in (125, 500):
        cb = torch.randn(1024, 192, generator=g, device="cuda")
        cb[7] = cb[3]  # an exact tie: both versions must pick index 3
        x = torch.randn(n, 192, generator=g, device="cuda")
        x[0] = cb[3]
        got, want = fn(x, cb), vq_nearest_plain(x, cb)
        torch.cuda.synchronize()
        dist = ((x * x).sum(1, keepdim=True) - 2.0 * (x @ cb.T)
                + (cb * cb).sum(1)[None])
        rows_i = torch.arange(n, device="cuda")
        d_got, d_want = dist[rows_i, got.long()], dist[rows_i, want.long()]
        diff = (d_got - d_want).abs()
        mism = got != want
        near = diff <= 1e-5 * d_want.abs().clamp_min(1e-30)
        bad = int((mism & ~near).sum())
        if int(got[0]) != 3 or bad:
            raise AssertionError(f"vq N={n}: {bad} code mismatches beyond a 1e-5 "
                                 f"relative near-tie, tie pick {int(got[0])}")
        ms, pms = median_ms(lambda: fn(x, cb)), median_ms(lambda: vq_nearest_plain(x, cb))
        log(f"(c) vq_nearest N={n} bins=1024 D=192 f32: mismatches {int(mism.sum())} "
            f"(near-ties {int((mism & near).sum())}, tolerance: mismatch only on "
            f"a <=1e-5 relative distance tie) | kernel {ms:.4f} ms, plain {pms:.4f} ms")
        rows.append({"name": "vq_nearest", "max_abs_err": float(diff.max()), "ms": ms,
                     "plain_ms": pms, "run": lambda: fn(x, cb),
                     "run_plain": lambda: vq_nearest_plain(x, cb)})


def _check_decode(g, rows):
    from ttts_tpu_torch.ops.cuda.decode_attention import decode_attention_plain

    fn = wrapper("decode_attention")
    h, dk, ml = 8, 64, 563
    for b in (1, 4):
        kc = torch.randn(b, h, ml, dk, generator=g, device="cuda").to(torch.bfloat16)
        vc = torch.randn(b, h, ml, dk, generator=g, device="cuda").to(torch.bfloat16)
        for pos in (0, ml // 2, ml - 1):
            q, uk, uv = (torch.randn(b, h, dk, generator=g, device="cuda").to(torch.bfloat16)
                         for _ in range(3))
            k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
            got = fn(q, uk, uv, k1, v1, pos)
            # the plain version on exact f32 copies: the reference before rounding
            want = decode_attention_plain(q.float(), uk.float(), uv.float(), k2.float(),
                                          v2.float(), pos)
            k3, v3 = kc.clone(), vc.clone()
            decode_attention_plain(q, uk, uv, k3, v3, pos)
            if not (torch.equal(k1, k3) and torch.equal(v1, v3)):
                raise AssertionError(f"decode B={b} pos={pos}: caches differ")
            _timed(rows, "decode_attention",
                   f"B={b} H={h} dk={dk} max_len={ml} pos={pos} bf16, caches equal",
                   compare(got, want), "excess", DECODE_TOL,
                   lambda: fn(q, uk, uv, k1, v1, pos),
                   lambda: decode_attention_plain(q, uk, uv, k3, v3, pos))


def _check_attention(g, rows):
    from ttts_tpu_torch.ops.cuda.attention import flash_attention_plain

    fn = wrapper("flash_bias_attention")
    # the path's shapes, as strided q/k/v views of one fused qkv as the model
    # passes them: the reference encoders at a 1 s prompt (T=94 refer_enc,
    # T=126 RefEncoder: ragged, most of the last key tile masked) and at a
    # 5 s prompt (T=501), and the trunk at two code buckets
    for b, t, h, d in ((1, 94, 16, 32), (1, 126, 8, 64), (1, 501, 8, 64),
                       (2, 1024, 16, 32), (2, 1600, 16, 32)):
        qkv = torch.randn(b, t, h, 3 * d, generator=g, device="cuda").to(torch.bfloat16)
        q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
        strip = torch.randn(h, 2 * t - 1, generator=g, device="cuda")
        got, want = fn(q, k, v, strip), flash_attention_plain(q, k, v, strip)
        torch.cuda.synchronize()
        _timed(rows, "flash_bias_attention", f"B={b} T={t} H={h} D={d} bf16",
               compare(got, want), "rel_l2", ATTN_TOL,
               lambda: fn(q, k, v, strip), lambda: flash_attention_plain(q, k, v, strip))


def _check_resblock(g, rows):
    from ttts_tpu_torch.ops.cuda.resblock import fused_scale_shift_resblock_plain

    fn = wrapper("scale_shift_resblock")
    c = 512
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    for b, t in ((2, 1024), (2, 1600)):
        x = rn(b, t, c).to(torch.bfloat16)
        args = (x, 1 + 0.1 * rn(c), 0.1 * rn(c),
                (rn(c, c) / math.sqrt(c)).to(torch.bfloat16), 0.1 * rn(c),
                1 + 0.1 * rn(b, c), 0.1 * rn(b, c),
                (rn(3, c, c) / math.sqrt(3 * c)).to(torch.bfloat16), 0.1 * rn(c))
        got, want = fn(*args), fused_scale_shift_resblock_plain(*args)
        torch.cuda.synchronize()
        _timed(rows, "scale_shift_resblock", f"B={b} T={t} C={c} bf16",
               compare(got, want), "excess", RES_TOL,
               lambda: fn(*args), lambda: fused_scale_shift_resblock_plain(*args))


def phase_kernels():
    g = torch.Generator("cuda").manual_seed(0)
    rows = []
    _check_vq(g, rows)
    _check_decode(g, rows)
    _check_attention(g, rows)
    _check_resblock(g, rows)
    return rows


# ---------------------------------------------------------------------- (d)


def synthetic_voice(seconds: float, sr: int, seed: int) -> np.ndarray:
    """A seeded voice-like signal: a gliding harmonic tone with noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 140.0 + 30.0 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    wav = sum(np.sin(k * phase) / k for k in range(1, 6))
    wav = 0.3 * wav * (0.6 + 0.4 * np.sin(2 * np.pi * 3.0 * t) ** 2)
    return (wav + 0.01 * rng.standard_normal(t.size)).astype(np.float32)


TEXT = "ni3 hao3 shi4 jie4 jin1 tian1 tian1 qi4 hen3 hao3"


def make_tts(device: str):
    """TextToSpeech(default_config()) on seeded random weights, with every
    attention output projection made non-zero (the same values on any
    device)."""
    from ttts_tpu_torch.api import TextToSpeech

    tts = TextToSpeech(device=device, seed=0)  # default_config()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in tts.diffusion.named_parameters():
            if name.endswith("proj_out.weight"):
                p.copy_(torch.randn(p.shape, generator=g) / math.sqrt(p.shape[1]))
    return tts


def phase_end_to_end():
    from ttts_tpu_torch.api import code_bucket

    t0 = time.perf_counter()
    tts = make_tts("cuda")
    log(f"(d) init: TextToSpeech(default_config(), cuda) {time.perf_counter() - t0:.2f} s")
    voice = synthetic_voice(5.0, 44100, seed=2)
    tts.profile_stages = True
    for name in KERNELS:
        wrapper(name).launches = 0
    for call in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wav = tts.tts(TEXT, voice, 44100, preset="ultra_fast", max_generate_length=400,
                      seed=call)
        wall = time.perf_counter() - t0
        code_len = len(tts.last_codes)
        bucket = code_bucket(code_len, 400)
        hop = tts.cfg.vocos.hop_length
        if not np.isfinite(wav).all():
            raise AssertionError("non-finite waveform")
        # Vocos yields (frames-1)*hop samples; the trim keeps code_len*4*hop
        if wav.shape != (min(code_len * 4 * hop, (bucket * 4 - 1) * hop),):
            raise AssertionError(f"waveform {wav.shape} vs code_len {code_len}")
        stages = " ".join(f"{k} {v * 1e3:.1f} ms" for k, v in tts.last_stage_times.items())
        audio_s = wav.shape[0] / tts.cfg.acoustic_mel.sample_rate
        log(f"(d) tts call {call}: code_len {code_len}, {wav.shape[0]} samples "
            f"({audio_s:.2f} s audio), wall {wall:.3f} s, RTF {wall / audio_s:.4f} | {stages}")
    launches = {name: wrapper(name).launches for name in KERNELS}
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels never launched by tts: {missing}")
    log(f"(d) launches in the two tts calls: {launches}")
    return tts, launches


# ---------------------------------------------------------------------- (e)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float((a - b).norm() / b.norm())


def phase_reference(gpu):
    # measured on an H100: 1.8e-7, 9.8e-3, 5.9e-3, 6.9e-3; a wrong kernel
    # gives errors of order 1
    tol = {"refer_mel": 1e-5, "logits": 3e-2, "mel": 2e-2, "wav": 3e-2}
    cpu = make_tts("cpu")
    g = torch.Generator().manual_seed(4)
    voice = synthetic_voice(1.0, 44100, seed=3)
    codes_g, mel_g = gpu.get_conditioning(voice, 44100)
    codes_c, refer = cpu.get_conditioning(voice, 44100)
    mism = int((codes_g.cpu() != codes_c).sum())
    errs = {"refer_mel": rel_err(mel_g.exp(), refer.exp())}

    ids = np.asarray(cpu.tok.encode(TEXT), np.int64)
    text = torch.as_tensor(np.pad(ids, (0, -len(ids) % 16)))[None]
    prompt = torch.nn.functional.pad(codes_c, (0, -codes_c.shape[1] % 16))
    toks = torch.randint(0, 1024, (8, 1), generator=g)
    n = text.shape[1] + 2 + prompt.shape[1] + 1
    with torch.no_grad():
        cache_g, lg, _, off = gpu.gpt.prefill(text.cuda(), prompt.cuda(), n + len(toks))
        cache_c, lc, _, _ = cpu.gpt.prefill(text, prompt, n + len(toks))
        worst = rel_err(lg, lc)
        for i, tok in enumerate(toks):
            lg = gpu.gpt.decode_one(tok.cuda(), cache_g, n + i, off + i)
            lc = cpu.gpt.decode_one(tok, cache_c, n + i, off + i)
            worst = max(worst, rel_err(lg, lc))
    errs["logits"] = worst

    codes = torch.randint(0, 1024, (1, 32), generator=g)
    noise = torch.randn(1, 128, 100, generator=g)
    mel_g, wav_g = gpu.tail(text.cuda(), codes.cuda(), 32, refer.cuda(), noise.cuda(), 10)
    mel_c, wav_c = cpu.tail(text, codes, 32, refer, noise, 10)
    errs["mel"], errs["wav"] = rel_err(mel_g, mel_c), rel_err(wav_g, wav_c)
    finite = all(torch.isfinite(t).all() for t in (mel_g, wav_g))
    log(f"(e) card vs f32 CPU path, default_config, 1 s prompt, 32 codes, 10 steps: "
        f"prompt-code mismatches {mism}/{codes_c.numel()} (tol 0); relative L2 errors "
        + ", ".join(f"{k} {v:.3e} (tol {tol[k]})" for k, v in errs.items()))
    bad = [k for k, v in errs.items() if not v <= tol[k]]
    if mism or bad or not finite:
        raise AssertionError(f"card path disagrees with the CPU path: {bad}, "
                             f"{mism} code mismatches, finite={finite}")


# ---------------------------------------------------------------------- (f)


def device_us(fn, reps: int = 20) -> str:
    """Device time per call of `fn` from torch.profiler: the total in us,
    then each device kernel's us and launches per call (a count below the
    wrapper's launches would show events the profiler dropped)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_kernel = _by_kernel(prof)
    total = sum(us for _, us in by_kernel.values()) / reps
    parts = ", ".join(f"{name[:28]} {us / reps:.1f} us x{n / reps:g}"
                      for name, (n, us) in by_kernel.items())
    return f"{total:.1f} us ({parts})"


def _by_kernel(prof) -> dict:
    """{device kernel name[:60]: (launches, total us)}, largest total first."""
    by_kernel: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, us = by_kernel.get(e.name[:60], (0, 0.0))
            by_kernel[e.name[:60]] = (n + 1, us + e.time_range.elapsed_us())
    return dict(sorted(by_kernel.items(), key=lambda kv: -kv[1][1]))


def phase_profile(rows, tts) -> None:
    """Device time of each kernel and its plain version at the largest
    phase-(c) shape, and the device's busy share of a steady tts call."""
    from torch.profiler import ProfilerActivity, profile

    for name in KERNELS:
        last = [r for r in rows if r["name"] == name][-1]
        log(f"(f) {name}, device time per call at the largest (c) shape: kernel "
            f"{device_us(last['run'])} | plain {device_us(last['run_plain'])}")
    voice = synthetic_voice(5.0, 44100, seed=2)
    tts.profile_stages = False
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tts.tts(TEXT, voice, 44100, max_generate_length=400, seed=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tts.tts(TEXT, voice, 44100, max_generate_length=400, seed=1)
        torch.cuda.synchronize()
    by_kernel = _by_kernel(prof)
    busy = sum(us for _, us in by_kernel.values()) / 1e6
    log(f"(f) steady tts call: wall {wall:.3f} s without the profiler, device busy "
        f"{busy:.3f} s under it: busy share {busy / wall:.3f}")
    for name, (n, us) in list(by_kernel.items())[:10]:
        log(f"(f)   {us / 1e3:9.2f} ms {n:6d} launches  {name}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    card = phase_card()
    phase_build()
    rows = phase_kernels()
    tts, launches = phase_end_to_end()
    phase_reference(tts)
    phase_profile(rows, tts)
    table = []
    for name, (_, _, source, replaces) in KERNELS.items():
        mine = [r for r in rows if r["name"] == name]
        last = mine[-1]  # the largest shape measured
        table.append({"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": launches[name],
                      "max_abs_err": max(r["max_abs_err"] for r in mine),
                      "ms": last["ms"], "plain_ms": last["plain_ms"]})
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
