"""Chip smoke test of the PyTorch / CUDA port (ttts_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one printed line each, any failure raising (non-zero exit):
  (a) the card (nvidia-smi name and power limit), torch and CUDA versions;
  (b) build the hand-written kernels from ttts_tpu_torch/csrc with nvcc (one
      process per source, all started together);
  (c) each kernel, and each attention mode, against its plain PyTorch
      version at the serving path's full-width shapes, in the working dtype:
      errors against the stated tolerance (relative: see compare and the
      *_TOL constants), the median time of the kernel, the plain version and
      the one PyTorch call that computes the same function where there is
      one, and the kernel's bound (section 4 of PERF.md);
  (d) end to end: TextToSpeech(default_config(), device="cuda") on random
      seeded weights (attention output projections made non-zero, since they
      are zero-initialised and would hide a wrong attention kernel), a seeded
      5 s 44.1 kHz synthetic voice and pinyin texts: `tts(...)` at the
      default preset "fast" twice, then at "ultra_fast" once, then
      `tts_batch` of two texts at "fast", all with max_generate_length=400.
      Checks finite waveforms of the lengths the code lengths imply, that
      every kernel and attention mode of the path was launched by these
      calls, and that each launched once per call of its model call sites
      (counted by hooks on the modules: no full-width call site took its
      plain version); times the gates' host cost. Then one trunk
      AttentionBlock with fused_gn off and on, the path of the fused
      GroupNorm -> qkv kernel (no model sets it);
  (e) the card's path against the port's f32 CPU path (which tests/
      test_torch_*.py hold to the JAX package) at the same full width and
      weights, on small inputs, stage by stage from shared inputs: prompt
      codes equal, GPT prefill + teacher-forced decode logits, the CLVP
      latents and similarities, and the latent → diffusion (10 steps, shared
      noise) → Vocos tail, each within a stated relative error (the card runs
      the GPT, CLVP and diffusion in bf16);
  (f) torch.profiler device time of each kernel (split into its launches
      by name), its plain version and library call, the products of the
      resblock, VQ and gn_qkv alone through cuBLAS (floors, not the same
      functions), and the device's busy share of a steady tts call at
      preset "fast";
  (g) the limits of the phase-(c) checks, each shown to fail its planted
      fault (FAULTS) in one of three copies of the kernels, built apart at
      once;
  (h) codec reconstruction at full width (run after (e)): SynthesizerTrn
      .infer on the seeded 5 s voice at 32 kHz and .decode of its codes, on
      the card and on the f32 CPU path with the same weights and z_p noise:
      codes equal, waveforms within CODEC_TOL, finite, frames x hop long,
      the VQ kernel launched by `infer`; median ms of each;
  (i) TextToSpeech on tests/test_api.py's TINY config on the card (after
      (h)): the shape gates send every shape outside a kernel's domain to its
      plain version;
  (j) the rest of the inference surface: TextToSpeech at
      default_config() widths with sampler "unipc" and the plain-Transformer
      CLVP (use_xformers=False), a warm-up, then steady "fast" calls in
      turns with phase (d)'s TextToSpeech (DPM, UniPC, UniPC, DPM): finite
      waveforms of the implied lengths, each kernel launched as often as its
      call sites were called and as phase (d)'s steady DPM call launched it
      (UniPC has the same NFE), no no-bias launch (the plain CLVP attends in
      plain PyTorch, f32); then the card against the port's
      f32 CPU path at the same weights, each relative error beside its limit
      (SLICE7_TOL): the UniPC tail ("unipc", "unipc_bh1", 10 steps, shared
      noise), the plain CLVP's latents and similarities, apply_typical's kept
      sets, a typical-sampling decode with the serving (bf16) GPT and with
      an f32 copy of the CPU's on the card, each teacher-forced on both
      paths with shared Gumbel draws (tokens equal wherever the kept sets
      are and the draw is decided by more than the logits' error; the f32
      one's kept sets equal in >= 90% of its draws), the classifier's
      logits, the Vocos ResNet backbone with each IMDCT head and
      imdct(mdct(x)), ConditioningEncoder (bf16, the no-bias kernel),
      MelEncoder, PerceiverResampler and one DiffusionTts forward (bf16, the
      bias kernel at D=32 and 64, the resblock kernel) on the 5 s voice's
      mel; median ms of each module call, and torch.profiler device time of
      the rerank alone in each CLVP flavour;
  (k) training (run last), at default_config() widths on a seeded synthetic
      dataset (64 rows: pinyin texts, 200-600 codes, 200-400 mel frames):
      train_gpt for 12 steps of batch 32 with checkpoints at 6 and 12, a
      resume from 6 to 12, then train_diffusion on the GPT it trained, the
      same way; every loss and grad norm finite, no kernel launched by a GPT
      step and only the frozen GPT's causal attention (one per layer) by a
      diffusion step; median steady step ms, tokens/s and mel frames/s,
      peak memory and the device's busy share of 3 steps under
      torch.profiler; the causal kernel against its plain version at the
      largest shape the diffusion step gave it (ATTN_TOL; a row of the
      kernel table); the card's bf16 step against the port's f32 CPU step
      at the same width, weights, 4 rows and draws (TRAIN_TOL: the frozen
      GPT's latent, losses, the global grad norm, per-tensor gradient
      cosines with the trunk's attention and resblock weights named); each
      raw kernel wrapper refusing an input that requires grad; both trained
      models exported (export_release) and served by
      TextToSpeech.from_checkpoints.
The last two lines are the kernel table as JSON and then
{"ok": true, "device": {...}}. Imports no JAX; needs a CUDA card.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from functools import partial

import numpy as np
import torch

ATTN_SRC, ATTN_TPU = "ttts_tpu_torch/csrc/attention.cu", "ttts_tpu/ops/pallas/attention.py"
RES_SRC, RES_TPU = "ttts_tpu_torch/csrc/resblock.cu", "ttts_tpu/ops/pallas/resblock.py"
KERNELS = {
    # name: (module, wrapper, attention mode, source, replaced TPU kernel)
    "vq_nearest": ("vq", "vq_nearest", None, "ttts_tpu_torch/csrc/vq.cu",
                   "ttts_tpu/ops/pallas/vq.py:76"),
    "decode_attention": ("decode_attention", "decode_attention", None,
                         "ttts_tpu_torch/csrc/decode_attention.cu",
                         "ttts_tpu/ops/pallas/decode_attention.py:180"),
    "flash_attention_bias": ("attention", "flash_attention", "bias", ATTN_SRC,
                             f"{ATTN_TPU}:169"),
    "flash_attention_nobias": ("attention", "flash_attention", "nobias", ATTN_SRC,
                               f"{ATTN_TPU}:182"),
    "flash_attention_causal": ("attention", "flash_attention", "causal", ATTN_SRC,
                               f"{ATTN_TPU}:72"),
    "flash_attention_bias_causal": ("attention", "flash_attention", "bias_causal", ATTN_SRC,
                                    f"{ATTN_TPU}:72"),
    "scale_shift_resblock": ("resblock", "fused_scale_shift_resblock", None, RES_SRC,
                             f"{RES_TPU}:142"),
    "gn_qkv": ("resblock", "fused_gn_qkv", None, RES_SRC, f"{RES_TPU}:243"),
}
# not on the serving path (no model sets AttentionBlock.fused_gn, as in the
# JAX package): it launches in its own step of phase (d)
OFF_PATH = ("gn_qkv",)
# a mode the TPU kernel computes and no caller uses: phase (c) only
NO_CALLER = ("flash_attention_bias_causal",)

# Published peaks of one H100 SXM at 700 W (NVIDIA H100 datasheet, dense)
PEAK_BF16, PEAK_F32, HBM_BYTES_S = 989e12, 67e12, 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def wrapper(name: str):
    import importlib

    mod, fn, _, _, _ = KERNELS[name]
    return getattr(importlib.import_module(f"ttts_tpu_torch.ops.cuda.{mod}"), fn)


def count(name: str) -> int:
    mode = KERNELS[name][2]
    return wrapper(name).launches[mode] if mode else wrapper(name).launches


def counts() -> dict:
    return {name: count(name) for name in KERNELS}


def reset_counts() -> None:
    for name, (_, _, mode, _, _) in KERNELS.items():
        if mode:
            launches = wrapper(name).launches
            for m in launches:
                launches[m] = 0
        else:
            wrapper(name).launches = 0


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


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16):
    """The least time the card could take: the larger of operations over the
    peak rate for their type and bytes over the memory rate → (ms, by)."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


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
#              -8.9e-6 to 0 (the cluster kernel); ranks 1-7 dropped from
#              the merge, 2.34;
#   attention: rel_l2 <= 5e-3 against the bf16 plain version (the kernel
#              rounds P to bf16 before P.V), in every mode: correct 1.7e-3
#              to 2.4e-3; the ragged-edge key mask removed 0.38 at T=32, the
#              causal mask off by one key 0.38, the strip segment one
#              diagonal off 1.08 (phase (g));
#   resblock, gn_qkv: excess <= 1e-3 against the bf16 plain version:
#              resblock correct 4e-5 to 3.3e-4; conv3's taps through a map
#              over B*T rows 0.20, h's ragged tile's partials dropped 1.1e-2,
#              the FiLM scale dropped 5.9e-2; gn_qkv correct 6e-9 to
#              3.9e-4, the GroupNorm scale g dropped 0.10, the mean dropped
#              0.31 (phase (g));
#   vq:        "wrong" = code mismatches beyond a 1e-5 relative distance tie,
#              plus one if the planted exact tie did not go to the lower
#              index: must be 0 (the kernel drops ||x||^2 and sums in
#              another order than the plain version, so near-ties may flip;
#              a wrong kernel flips whole rows): correct 0; ties to the
#              higher index 1, rank 7 dropped 62, ||e||^2 dropped 407.
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


def _timed(rows, name, shape, m, metric, tol, run, run_plain, run_library, work):
    """Check m[metric] <= tol (metric None: the caller checked), then time
    kernel, plain version and library call (None: no single call), each a
    call bound to this shape's inputs (phase (f) calls them again); `work` =
    (operations, bytes[, peak]) of the function at this shape."""
    ms, pms = median_ms(run), median_ms(run_plain)
    lms = median_ms(run_library) if run_library else None
    bms, by = bound(*work)
    lib = f"{lms:.4f} ms" if lms is not None else "none"
    err = ", ".join([f"max_abs_err {m['max_abs']:.3e}"] + [
        f"{k} {m[k]:.3e}" for k in ("rel_l2", "excess", "wrong") if k in m])
    if metric:
        err += f" (tol: {metric} <= {tol})"
    log(f"(c) {name} {shape}: {err} | kernel {ms:.4f} ms, plain {pms:.4f} ms, "
        f"library {lib}, bound {bms:.4f} ms ({by})")
    rows.append({"name": name, "shape": shape, "max_abs_err": m["max_abs"], "ms": ms,
                 "plain_ms": pms, "library_ms": lms, "bound_ms": bms, "bound_by": by,
                 "run": run, "run_plain": run_plain, "run_library": run_library})
    if metric and not m[metric] <= tol:
        raise AssertionError(f"{name} {shape}: {metric} {m[metric]:.3e} > {tol}")


def _vq_inputs(g, n, bins):
    """x (n, 192), codebook (bins, 192) with an exact tie: code 7 = code 3 =
    x[0], so both versions must pick index 3 for row 0."""
    cb = torch.randn(bins, 192, generator=g, device="cuda")
    cb[7] = cb[3]
    x = torch.randn(n, 192, generator=g, device="cuda")
    x[0] = cb[3]
    return x, cb


def _vq_reading(x, cb, got) -> dict:
    """The kernel's codes `got` against the plain version's: max_abs, the
    largest gap between the two codes' distances; wrong, the mismatches
    beyond a 1e-5 relative near-tie plus one if row 0's exact tie did not go
    to index 3; mism and near, the mismatches and the near-ties among them."""
    from ttts_tpu_torch.ops.cuda.vq import vq_nearest_plain

    want = vq_nearest_plain(x, cb)
    dist = ((x * x).sum(1, keepdim=True) - 2.0 * (x @ cb.T) + (cb * cb).sum(1)[None])
    rows_i = torch.arange(x.shape[0], device=x.device)
    d_got, d_want = dist[rows_i, got.long()], dist[rows_i, want.long()]
    diff = (d_got - d_want).abs()
    mism = got != want
    near = diff <= 1e-5 * d_want.abs().clamp_min(1e-30)
    return {"max_abs": float(diff.max()),
            "wrong": float(int((mism & ~near).sum()) + (int(got[0]) != 3)),
            "mism": int(mism.sum()), "near": int((mism & near).sum())}


def _check_vq(g, rows):
    from ttts_tpu_torch.ops.cuda.vq import vq_nearest_plain

    fn = wrapper("vq_nearest")
    edge = _edge_generator()
    # one row (one cluster, 39 zero-filled rows never written), 33 rows
    # (one ragged 40-row tile), a bins that is no multiple of the 128-code
    # slice (the last slice's zero-filled codes masked), then the codec's
    # shapes (N=125: a ragged last tile of 5 rows; N=500: 13 tiles, 104
    # blocks)
    for gen, (n, bins) in ((edge, (1, 1024)), (edge, (33, 1024)), (edge, (500, 1000)),
                           (g, (125, 1024)), (g, (500, 1024))):
        x, cb = _vq_inputs(gen, n, bins)
        m = _vq_reading(x, cb, fn(x, cb))
        torch.cuda.synchronize()
        _timed(rows, "vq_nearest",
               f"N={n} bins={bins} D=192 f32: mismatches {m['mism']} (near-ties {m['near']}; "
               "tolerance: a mismatch only on a <=1e-5 relative distance tie, the exact tie "
               "to index 3), distance gap", m, "wrong", 0,
               partial(fn, x, cb), partial(vq_nearest_plain, x, cb), None,
               (2 * n * bins * 192, (n * 192 + bins * 192 + n) * 4, PEAK_F32))


def _check_decode(g, rows):
    from ttts_tpu_torch.ops.cuda.decode_attention import decode_attention_plain

    sdpa = torch.nn.functional.scaled_dot_product_attention
    fn = wrapper("decode_attention")
    h, dk, ml = 8, 64, 563
    # positions on the boundaries of the 8 cluster ranks' shares of rows
    # [0, pos] (ceil((pos+1)/8) rows each): one row, ranks 1-7 empty (0);
    # rank 1's first row (1); one row per rank (7); rank 4 short, 5-7 empty
    # (8); 8 full shares of 8 (63), then 9 with rank 7 one row short (64);
    # the middle and the end of the path's 563-row cache (281, 562)
    for b in (1, 4):
        kc = torch.randn(b, h, ml, dk, generator=g, device="cuda").to(torch.bfloat16)
        vc = torch.randn(b, h, ml, dk, generator=g, device="cuda").to(torch.bfloat16)
        for pos in (0, 1, 7, 8, 63, 64, 281, ml - 1):
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
            # library: SDPA at query length 1 over the rows <= pos, without
            # the row write
            q4, kl, vl = q[:, :, None], k1[:, :, : pos + 1], v1[:, :, : pos + 1]
            bh = b * h * dk * 2
            _timed(rows, "decode_attention",
                   f"B={b} H={h} dk={dk} max_len={ml} pos={pos} bf16, caches equal",
                   compare(got, want), "excess", DECODE_TOL,
                   partial(fn, q, uk, uv, k1, v1, pos),
                   partial(decode_attention_plain, q, uk, uv, k3, v3, pos),
                   partial(sdpa, q4, kl, vl),
                   (4 * b * h * (pos + 1) * dk, 6 * bh + 2 * pos * bh))


def _attention_work(b, t, h, d, bias, causal):
    pairs = t * (t + 1) // 2 if causal else t * t
    return 4 * b * h * pairs * d, 4 * b * t * h * d * 2 + (h * (2 * t - 1) * 4 if bias else 0)


def _edge_generator():
    """The inputs of the tile-edge rows: a generator of their own, so that
    the path's rows draw the same inputs with or without them (their
    readings can be held against another version of the kernels)."""
    return torch.Generator("cuda").manual_seed(9)


def _check_attention(g, rows):
    from ttts_tpu_torch.ops.cuda.attention import flash_attention_plain, toeplitz_bias

    sdpa = torch.nn.functional.scaled_dot_product_attention
    fn = wrapper("flash_attention_bias")
    bf = torch.bfloat16
    edge = _edge_generator()
    # bias mode, as strided q/k/v views of one fused per-head [q; k; v]
    # tensor as the diffusion net passes them: a last key tile of one key
    # (T=65) and a refilled ring stage past two tiles (T=129) at both head
    # widths, then the path's shapes: the reference encoders at a 1 s prompt
    # (T=94 refer_enc, T=126 RefEncoder: ragged, most of the last key tile
    # masked) and at a 5 s prompt (T=501), and the trunk at two code buckets
    # ... and DiffusionTts's contextual_attn at a 5 s conditioning mel
    # (CTX_SHAPE, D=64), drawn after them from the same generator
    shapes = [(edge, s) for s in ((1, 65, 16, 32), (1, 65, 8, 64), (2, 129, 16, 32),
                                  (2, 129, 8, 64), CTX_SHAPE)]
    shapes += [(g, s) for s in ((1, 94, 16, 32), (1, 126, 8, 64), (1, 501, 8, 64),
                                (2, 1024, 16, 32), (2, 1600, 16, 32))]
    for gen, (b, t, h, d) in shapes:
        qkv = torch.randn(b, t, h, 3 * d, generator=gen, device="cuda").to(bf)
        q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
        strip = torch.randn(h, 2 * t - 1, generator=gen, device="cuda")
        got, want = fn(q, k, v, strip), flash_attention_plain(q, k, v, strip)
        torch.cuda.synchronize()
        # library: SDPA with the (H, T, T) bias built beforehand (not timed)
        qt, kt, vt = (z.transpose(1, 2) for z in (q, k, v))
        mask = toeplitz_bias(strip, t).to(bf)[None]
        _timed(rows, "flash_attention_bias", f"B={b} T={t} H={h} D={d} bf16",
               compare(got, want), "rel_l2", ATTN_TOL,
               partial(fn, q, k, v, strip), partial(flash_attention_plain, q, k, v, strip),
               partial(sdpa, qt, kt, vt, attn_mask=mask),
               _attention_work(b, t, h, d, True, False))
    # no-bias mode: one exact 64-key tile, a last tile of one key (T=65), a
    # head width of 32 over three tiles (the ring's stages refilled), then
    # CLVP's shapes: separate (B, T, H, D) tensors, as the rotary embedding
    # leaves them (text T=32, speech T=400)
    for b, t, h, d in ((1, 64, 1, 64), (2, 65, 4, 64), (2, 129, 16, 32), (4, 32, 16, 64),
                       (4, 400, 16, 64)):
        q, k, v = (torch.randn(b, t, h, d, generator=g, device="cuda").to(bf) for _ in range(3))
        got, want = fn(q, k, v), flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        qt, kt, vt = (z.transpose(1, 2) for z in (q, k, v))
        _timed(rows, "flash_attention_nobias", f"B={b} T={t} H={h} D={d} bf16",
               compare(got, want), "rel_l2", ATTN_TOL,
               partial(fn, q, k, v), partial(flash_attention_plain, q, k, v),
               partial(sdpa, qt, kt, vt), _attention_work(b, t, h, d, False, False))
    # causal mode: a last tile of one key (T=65) and a head width of 32
    # (T=129), then the GPT's shapes, as views of its fused [q; k; v]
    # projection: a ragged T=100, the prefill of 4 candidates (T=163) and
    # the return_latent forward of one winner (T=436)
    # (bias + causal, which no caller uses, is checked at both head widths
    # before the path's causal rows; library: SDPA with the bias and the
    # causal mask built beforehand)
    for gen, (b, t, h, d) in ((edge, (2, 129, 16, 32)), (g, (1, 163, 8, 64))):
        strip = torch.randn(h, 2 * t - 1, generator=gen, device="cuda")
        q, k, v = (torch.randn(b, t, h, d, generator=gen, device="cuda").to(bf)
                   for _ in range(3))
        qt, kt, vt = (z.transpose(1, 2) for z in (q, k, v))
        keep = torch.ones(t, t, dtype=torch.bool, device="cuda").tril()
        mask = toeplitz_bias(strip, t).masked_fill(~keep, -math.inf).to(bf)[None]
        _timed(rows, "flash_attention_bias_causal", f"B={b} T={t} H={h} D={d} bf16",
               compare(fn(q, k, v, strip, causal=True),
                       flash_attention_plain(q, k, v, strip, causal=True)), "rel_l2", ATTN_TOL,
               partial(fn, q, k, v, strip, causal=True),
               partial(flash_attention_plain, q, k, v, strip, causal=True),
               partial(sdpa, qt, kt, vt, attn_mask=mask),
               _attention_work(b, t, h, d, True, True))
    for b, t, h, d in ((1, 65, 8, 64), (2, 129, 4, 32), (2, 100, 8, 64), (4, 163, 8, 64),
                       (1, 436, 8, 64)):
        qkv = torch.randn(b, t, 3 * h * d, generator=g, device="cuda").to(bf)
        q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].reshape(b, t, h, d) for i in range(3))
        got = fn(q, k, v, causal=True)
        want = flash_attention_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        qt, kt, vt = (z.transpose(1, 2) for z in (q, k, v))
        _timed(rows, "flash_attention_causal", f"B={b} T={t} H={h} D={d} bf16",
               compare(got, want), "rel_l2", ATTN_TOL,
               partial(fn, q, k, v, causal=True),
               partial(flash_attention_plain, q, k, v, causal=True),
               partial(sdpa, qt, kt, vt, is_causal=True),
               _attention_work(b, t, h, d, False, True))


def _resblock_args(g, b, t, c):
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    return ((rn(b, t, c)).to(torch.bfloat16), 1 + 0.1 * rn(c), 0.1 * rn(c),
            (rn(c, c) / math.sqrt(c)).to(torch.bfloat16), 0.1 * rn(c),
            1 + 0.1 * rn(b, c), 0.1 * rn(b, c),
            (rn(3, c, c) / math.sqrt(3 * c)).to(torch.bfloat16), 0.1 * rn(c))


def _check_resblock(g, rows):
    from ttts_tpu_torch.ops.cuda.resblock import fused_scale_shift_resblock_plain

    fn = wrapper("scale_shift_resblock")
    c = 512
    # T=96: one ragged 128-row tile; B=1 T=1600 (a ragged last tile of 64
    # rows, no neighbouring batch); T=1632 (51 code buckets of 32, a last
    # tile of 96 rows); then the path's buckets, T=1600 the longest
    edge = _edge_generator()
    for gen, (b, t) in ((edge, (2, 96)), (edge, (1, 1600)), (edge, (2, 1632)), (g, (2, 1024)),
                        (g, (2, 1600))):
        args = _resblock_args(gen, b, t, c)
        got, want = fn(*args), fused_scale_shift_resblock_plain(*args)
        torch.cuda.synchronize()
        _timed(rows, "scale_shift_resblock", f"B={b} T={t} C={c} bf16",
               compare(got, want), "excess", RES_TOL,
               partial(fn, *args), partial(fused_scale_shift_resblock_plain, *args), None,
               (8 * b * t * c * c, 4 * b * t * c + 8 * c * c + 16 * c + 8 * b * c))


def _gn_qkv_args(g, b, t, c, shift: float = 0.0, scale: float = 1.0):
    """x = shift + scale * N(0, 1): a shift and scale away from 0 and 1 make
    the GroupNorm's mean and 1/std matter to the output."""
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    return ((shift + scale * rn(b, t, c)).to(torch.bfloat16), 1 + 0.1 * rn(c), 0.1 * rn(c),
            (rn(c, 3 * c) / math.sqrt(c)).to(torch.bfloat16), 0.1 * rn(3 * c))


def _check_gn_qkv(g, rows):
    from ttts_tpu_torch.ops.cuda.resblock import fused_gn_qkv_plain

    fn = wrapper("gn_qkv")
    c = 512
    edge = _edge_generator()
    # T=65: one ragged 128-row tile (rows 65-127 zero-filled, never stored)
    # of x shifted and scaled, then the trunk's buckets at B=2 and 4
    for gen, (b, t), shift in ((edge, (1, 65), 1.0), (g, (2, 1024), 0.0), (g, (4, 1024), 0.0),
                               (g, (2, 1600), 0.0), (g, (4, 1600), 0.0)):
        args = _gn_qkv_args(gen, b, t, c, shift, 1.0 + shift)
        got, want = fn(*args), fused_gn_qkv_plain(*args)
        torch.cuda.synchronize()
        _timed(rows, "gn_qkv", f"B={b} T={t} C={c} -> 3C bf16",
               compare(got, want), "excess", RES_TOL,
               partial(fn, *args), partial(fused_gn_qkv_plain, *args), None,
               (6 * b * t * c * c, 8 * b * t * c + 6 * c * c + 20 * c))


def phase_kernels():
    g = torch.Generator("cuda").manual_seed(0)
    rows = []
    _check_vq(g, rows)
    _check_decode(g, rows)
    _check_attention(g, rows)
    _check_resblock(g, rows)
    _check_gn_qkv(g, rows)
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
TEXT2 = "wo3 men5 yi4 qi3 qu4 gong1 yuan2 san4 bu4 ba5"


def nonzero_proj_out(model: torch.nn.Module, seed: int = 1) -> torch.nn.Module:
    """Every AttentionBlock output projection (zero-initialised, which would
    hide a wrong attention kernel) made non-zero, the same values on any
    device."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("proj_out.weight"):
                p.copy_(torch.randn(p.shape, generator=g) / math.sqrt(p.shape[1]))
    return model


def make_tts(device: str, cfg=None):
    """TextToSpeech(cfg or default_config()) on seeded random weights, with
    the diffusion net's attention output projections made non-zero."""
    from ttts_tpu_torch.api import TextToSpeech

    tts = TextToSpeech(cfg, device=device, seed=0)
    nonzero_proj_out(tts.diffusion)
    return tts


def _check_wavs(tts, wavs) -> None:
    """Finite waveforms, each of the length its winner's code length implies
    (Vocos yields (frames - 1) * hop samples; the trim keeps code_len*4*hop)."""
    from ttts_tpu_torch.api import code_bucket

    hop = tts.cfg.vocos.hop_length
    bucket = code_bucket(max(tts.last_code_lens), tts.last_codes.shape[1])
    for wav, cl in zip(wavs, tts.last_code_lens):
        if not np.isfinite(wav).all():
            raise AssertionError("non-finite waveform")
        if wav.shape != (min(cl * 4 * hop, (bucket * 4 - 1) * hop),):
            raise AssertionError(f"waveform {wav.shape} vs code_len {cl}")


def _watch_call_sites(*models):
    """Count the calls of each path kernel's model call sites in `models`,
    apart from the dispatch and the wrappers' counts: forward pre-hooks on
    the GPT blocks (a cached one-row step is a decode, any other call a
    causal attention), CLVP's unmasked x-transformers attentions, the
    diffusion AttentionBlocks (bias, or no bias without relative position
    embeddings; gn_qkv with fused_gn) and ScaleShiftResBlocks, and a wrapper
    around models.quantize.nearest. Returns (counts by kernel, undo)."""
    from ttts_tpu_torch.models import clvp, diffusion_net, gpt, quantize

    sites = dict.fromkeys(KERNELS, 0)

    def gpt_block(mod, args, kwargs):
        cache = args[1] if len(args) > 1 else kwargs.get("cache")
        one_row = cache is not None and args[0].shape[1] == 1
        sites["decode_attention" if one_row else "flash_attention_causal"] += 1

    def clvp_attention(mod, args, kwargs):
        if (args[1] if len(args) > 1 else kwargs.get("mask")) is None:
            sites["flash_attention_nobias"] += 1

    def attention_block(mod, args, kwargs):
        bias = mod.relative_pos_embeddings is not None
        sites["flash_attention_bias" if bias else "flash_attention_nobias"] += 1
        sites["gn_qkv"] += int(mod.fused_gn)

    def resblock(mod, args, kwargs):
        sites["scale_shift_resblock"] += 1

    hooks = {gpt.GPT2Block: gpt_block, clvp.Attention: clvp_attention,
             diffusion_net.AttentionBlock: attention_block,
             diffusion_net.ScaleShiftResBlock: resblock}
    handles = [m.register_forward_pre_hook(hooks[type(m)], with_kwargs=True)
               for model in models for m in model.modules()
               if type(m) in hooks]
    nearest = quantize.nearest

    def counted(x, embed):
        sites["vq_nearest"] += 1
        return nearest(x, embed)

    quantize.nearest = counted

    def undo():
        for h in handles:
            h.remove()
        quantize.nearest = nearest

    return sites, undo


def _gate_host_us(reps: int = 5000) -> dict:
    """Host microseconds of one gate decision of each dispatch (attention's
    kernel_fits, decode_attention.pick, resblock_fits, kernel_fits of VQ) on
    card tensors of the path's full-width shapes, timed over `reps` calls."""
    from ttts_tpu_torch.ops.cuda import attention, decode_attention, resblock, vq

    e = partial(torch.empty, device="cuda")
    qkv = e(2, 1600, 16, 96, dtype=torch.bfloat16)
    q, k, v = qkv[..., :32], qkv[..., 32:64], qkv[..., 64:]
    c = 512
    res = (e(2, 1600, c, dtype=torch.bfloat16), e(c), e(c), e(c, c, dtype=torch.bfloat16),
           e(c), e(2, c), e(2, c), e(3, c, c, dtype=torch.bfloat16), e(c))
    x, book = e(125, 192), e(1024, 192)
    gates = {"attention": lambda: attention.kernel_fits(q, k, v),
             "decode_attention": lambda: decode_attention.pick(torch.bfloat16, 64),
             "scale_shift_resblock": lambda: resblock.resblock_fits(*res, groups=32),
             "vq_nearest": lambda: vq.kernel_fits(x, book)}
    out = {}
    for name, gate in gates.items():
        assert gate()
        t0 = time.perf_counter()
        for _ in range(reps):
            gate()
        out[name] = (time.perf_counter() - t0) / reps * 1e6
    return out


def phase_end_to_end():
    t0 = time.perf_counter()
    tts = make_tts("cuda")
    log(f"(d) init: TextToSpeech(default_config(), cuda) {time.perf_counter() - t0:.2f} s")
    voice = synthetic_voice(5.0, 44100, seed=2)
    sr_out = tts.cfg.acoustic_mel.sample_rate
    tts.profile_stages = True
    sites, undo = _watch_call_sites(tts.gpt, tts.clvp, tts.diffusion)
    reset_counts()
    snaps, site_snaps, rtf, walls = [], [], {}, []
    for call, preset in enumerate(("fast", "fast", "ultra_fast")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wav = tts.tts(TEXT, voice, 44100, preset=preset, max_generate_length=400, seed=call)
        wall = time.perf_counter() - t0
        snaps.append(counts())
        site_snaps.append(dict(sites))
        walls.append(wall)
        _check_wavs(tts, [wav])
        stages = " ".join(f"{k} {v * 1e3:.1f} ms" for k, v in tts.last_stage_times.items())
        audio_s = wav.shape[0] / sr_out
        rtf[preset] = wall / audio_s
        log(f"(d) tts call {call}, preset {preset}: code_len {tts.last_code_lens[0]} "
            f"(candidate {tts.last_best[0]} of {tts.last_codes.shape[0]}), {wav.shape[0]} "
            f"samples ({audio_s:.2f} s audio), wall {wall:.3f} s, RTF {wall / audio_s:.4f} "
            f"| {stages}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wavs = tts.tts_batch([TEXT, TEXT2], voice, 44100, max_generate_length=400, seed=3)
    wall = time.perf_counter() - t0
    _check_wavs(tts, wavs)
    stages = " ".join(f"{k} {v * 1e3:.1f} ms" for k, v in tts.last_stage_times.items())
    audio_s = sum(w.shape[0] for w in wavs) / sr_out
    log(f"(d) tts_batch of 2 texts, preset fast: code_lens {tts.last_code_lens}, "
        f"{audio_s:.2f} s audio, wall {wall:.3f} s, {wall / 2:.3f} s per stream, "
        f"RTF {wall / audio_s:.4f} | {stages}")
    undo()
    launches = counts()
    per_fast = {n: snaps[1][n] - snaps[0][n] for n in KERNELS}
    sites_fast = {n: site_snaps[1][n] - site_snaps[0][n] for n in KERNELS}
    missing = [n for n, c in launches.items()
               if c == 0 and n not in OFF_PATH + NO_CALLER]
    if missing:
        raise AssertionError(f"kernels never launched by the tts calls: {missing}")
    log(f"(d) launches in the four calls: {launches}; in the steady fast call: {per_fast}")
    # at full width every call site is in its kernel's domain: a call site
    # that took the plain version shows as fewer launches than calls
    short = {n: (launches[n], sites[n]) for n in KERNELS if launches[n] != sites[n]}
    if short:
        raise AssertionError(f"launches != call-site calls (launches, calls): {short}")
    log(f"(d) every call site launched its kernel: call-site calls in the four calls "
        f"{sites}, in the steady fast call {sites_fast}")
    us = _gate_host_us()
    # the decode choice is made once per inference_speech call, every other gate per call
    evals = {"attention": sum(sites_fast[n] for n in sites_fast if n.startswith("flash")),
             "decode_attention": 1, "scale_shift_resblock": sites_fast["scale_shift_resblock"],
             "vq_nearest": sites_fast["vq_nearest"]}
    gate_ms = sum(us[n] * evals[n] for n in us) / 1e3
    log(f"(d) gate host cost: {', '.join(f'{n} {us[n]:.3f} us' for n in us)} per decision "
        f"(time.perf_counter over 5000 calls); {evals} decisions in the steady fast call "
        f"= {gate_ms:.3f} ms of its {walls[1] * 1e3:.1f} ms wall")
    launches.update(_fused_gn_ab(tts))
    return tts, launches, per_fast, rtf


def _fused_gn_ab(tts) -> dict:
    """One trunk AttentionBlock at (B=2, T=1600, C=512) with fused_gn off and
    on: relative L2 between the two and both times. Returns the gn_qkv
    launch count of the fused_gn run."""
    blk = tts.diffusion.layers[0].attn
    g = torch.Generator("cuda").manual_seed(5)
    x = torch.randn(2, 1600, 512, generator=g, device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        strip = blk.relative_pos_embeddings.strip(1600)
        off = blk(x, strip)
        ms_off = median_ms(lambda: blk(x, strip))
        reset_counts()
        blk.fused_gn = True
        try:
            on = blk(x, strip)
            n = count("gn_qkv")
            ms_on = median_ms(lambda: blk(x, strip))
        finally:
            blk.fused_gn = False
    torch.cuda.synchronize()
    err = float((on.float() - off.float()).norm() / off.float().norm())
    log(f"(d) trunk AttentionBlock B=2 T=1600 C=512: fused_gn on vs off rel_l2 {err:.3e} "
        f"(tol {ATTN_TOL}) | off {ms_off:.4f} ms, on {ms_on:.4f} ms; gn_qkv launches {n}")
    if not err <= ATTN_TOL or n == 0:
        raise AssertionError(f"fused_gn: rel_l2 {err:.3e}, {n} gn_qkv launches")
    return {"gn_qkv": n}


# ---------------------------------------------------------------------- (h)

# The codec's waveform on the card against the f32 CPU path, both f32 with
# TF32 off (phase (a)), relative L2 over the waveform. 1e-3 is the repo's
# contract for activations and waveforms (BASELINE.md:36-37). Codes: 0
# mismatches, as phase (e)'s prompt codes.
CODEC_TOL = 1e-3


def phase_codec(card: str) -> dict:
    """(h) Codec reconstruction at full width: SynthesizerTrn(default_config()
    .vqvae) from seeded weights on the card and the same weights on the CPU
    in f32; `infer` on the seeded 5 s voice resampled to 32 kHz, then
    `decode` of its codes, each with the same z_p noise on both. The VQ
    kernel's launches are read across the first `infer` (its path); returns
    them by kernel."""
    import copy

    from ttts_tpu_torch.config import default_config
    from ttts_tpu_torch.models.vqvae import SynthesizerTrn
    from ttts_tpu_torch.ops.mel import vits_spectrogram
    from ttts_tpu_torch.ops.resample import resample

    cfg = default_config()
    a, c = cfg.audio, cfg.vqvae
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        cpu = SynthesizerTrn(c, spec_channels=a.filter_length // 2 + 1).eval()
    gpu = copy.deepcopy(cpu).cuda()
    wav = resample(torch.from_numpy(synthetic_voice(5.0, 44100, seed=2))[None], 44100,
                   a.sampling_rate)
    wav = wav[:, : wav.shape[1] // (2 * a.hop_length) * 2 * a.hop_length]
    spec = vits_spectrogram(wav, a.filter_length, a.hop_length, a.win_length).transpose(1, 2)
    frames = spec.shape[1]
    g = torch.Generator().manual_seed(8)
    text = torch.randint(0, c.n_text_tokens, (1, 16), generator=g)
    noise = torch.randn(1, frames, c.inter_channels, generator=g)
    cpu_args = (wav[..., None], spec, torch.tensor([frames]), text, torch.tensor([16]), 0.5)
    gpu_args = tuple(x.cuda() if torch.is_tensor(x) else x for x in cpu_args)
    codes = {}  # each model's codes in its first infer: its quantizer's output

    def keep(name):
        def hook(module, args, out):
            codes.setdefault(name, out[1])
        return hook

    for name, model in (("gpu", gpu), ("cpu", cpu)):
        model.quantizer.register_forward_hook(keep(name))
    with torch.no_grad():
        torch.cuda.synchronize()
        reset_counts()
        out_g = gpu.infer(*gpu_args, noise=noise.cuda())
        torch.cuda.synchronize()
        launches = counts()
        out_c = cpu.infer(*cpu_args, noise=noise)
        codes_g, codes_c = codes["gpu"], codes["cpu"]
        dec_g = gpu.decode(codes_g, text.cuda(), spec.cuda(), 0.5, noise=noise.cuda())
        dec_c = cpu.decode(codes_c, text, spec, 0.5, noise=noise)
        run_infer = partial(gpu.infer, *gpu_args, noise=noise.cuda())
        run_decode = partial(gpu.decode, codes_g, text.cuda(), spec.cuda(), 0.5,
                             noise=noise.cuda())
        infer_ms = median_ms(run_infer, reps=5, warmup=1)
        decode_ms = median_ms(run_decode, reps=5, warmup=1)
        busy = {name: _device_busy(fn) for name, fn in (("infer", run_infer),
                                                        ("decode", run_decode))}
    mism = int((codes_g.cpu() != codes_c).sum())
    errs = {"infer": rel_err(out_g, out_c), "decode": rel_err(dec_g, dec_c)}
    want = (1, frames * a.hop_length, 1)
    finite = all(bool(torch.isfinite(x).all()) for x in (out_g, dec_g))
    log(f"(h) codec reconstruction, default_config, 5 s voice at {a.sampling_rate} Hz "
        f"({frames} frames, {codes_c.shape[-1]} codes): code mismatches card vs CPU "
        f"{mism}/{codes_c.numel()} (tol 0); waveform relative error infer "
        f"{errs['infer']:.3e}, decode {errs['decode']:.3e} (tol {CODEC_TOL}); shapes "
        f"{tuple(out_g.shape)}, {tuple(dec_g.shape)} (want {want}), finite {finite} | "
        f"infer {infer_ms:.2f} ms, decode {decode_ms:.2f} ms (median of 5, CUDA events; "
        f"{card}) | "
        f"VQ launches in the first infer {launches['vq_nearest']}")
    for name, (ms, n, top) in busy.items():
        log(f"(h) {name}: device busy {ms:.2f} ms in {n} kernel launches (torch.profiler, "
            f"one call); largest: " + ", ".join(f"{k[:40]} {us / 1e3:.2f} ms x{c}"
                                                 for k, (c, us) in top))
    bad = [k for k, v in errs.items() if not v <= CODEC_TOL]
    if (mism or bad or not finite or tuple(out_g.shape) != want
            or tuple(dec_g.shape) != want or launches["vq_nearest"] < 1):
        raise AssertionError(f"codec: {mism} code mismatches, errors over tol {bad}, "
                             f"finite={finite}, shapes {tuple(out_g.shape)} "
                             f"{tuple(dec_g.shape)}, VQ launches {launches['vq_nearest']}")
    return launches


def _device_busy(fn, top: int = 5):
    """(device ms, kernel launches, the `top` largest kernels) of one call
    of `fn` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_kernel = _by_kernel(prof)
    return (sum(us for _, us in by_kernel.values()) / 1e3,
            sum(n for n, _ in by_kernel.values()), list(by_kernel.items())[:top])


def tiny_config():
    """tests/test_api.py's TINY configuration in the port's classes: widths
    outside every kernel's domain but the causal and no-bias attention's
    (codec D=16, GPT dk=32, trunk C=64 with D=16)."""
    from ttts_tpu_torch import config as pc

    return pc.TTTSConfig(
        audio=pc.AudioConfig(sampling_rate=32000, filter_length=1024, hop_length=640,
                             win_length=1024, n_mel_channels=32),
        acoustic_mel=pc.AcousticMelConfig(sample_rate=24000, n_fft=256, hop_length=256,
                                          n_mels=100),
        vqvae=pc.VQVAEConfig(inter_channels=16, hidden_channels=16, filter_channels=32,
                             n_heads=2, n_layers=2, p_dropout=0.0,
                             upsample_initial_channel=32, gin_channels=16,
                             codebook_bins=32, posterior_wn_layers=2, flow_layers=1,
                             flow_wn_layers=1),
        gpt=pc.GPTConfig(model_dim=64, layers=1, heads=2, max_text_tokens=64,
                         max_mel_tokens=128, number_mel_codes=1026,
                         start_mel_token=1024, stop_mel_token=1025),
        diffusion_net=pc.DiffusionNetConfig(in_channels=100, out_channels=200,
                                            model_channels=64, num_heads=4, num_layers=1,
                                            in_latent_channels=64),
        clvp=pc.CLVPConfig(dim_text=32, dim_speech=32, dim_latent=16,
                           num_text_tokens=256, num_speech_tokens=1026,
                           text_enc_depth=1, speech_enc_depth=1, text_heads=2,
                           speech_heads=2),
        vocos=pc.VocosConfig(input_channels=100, dim=32, intermediate_dim=96,
                             num_layers=1, n_fft=1024, hop_length=256),
        train=pc.TrainConfig(segment_size=640 * 4))


def phase_tiny() -> dict:
    """(i) TextToSpeech(TINY, device="cuda"): "ultra_fast" and "fast" `tts`
    with a short max_generate_length. The shape gates route every shape
    outside a kernel's domain to its plain version; returns the launches."""
    from ttts_tpu_torch.api import TextToSpeech

    tts = TextToSpeech(tiny_config(), device="cuda", seed=0)
    voice = synthetic_voice(1.0, 44100, seed=3)
    reset_counts()
    for preset in ("ultra_fast", "fast"):
        wav = tts.tts(TEXT, voice, 44100, preset=preset, max_generate_length=32, seed=1)
        _check_wavs(tts, [wav])
    torch.cuda.synchronize()
    launches = {n: v for n, v in counts().items() if v}
    log(f"(i) TINY TextToSpeech on the card: 'ultra_fast' and 'fast' tts, code_len "
        f"{tts.last_code_lens[0]}, {wav.shape[0]} samples, finite; kernels launched "
        f"{launches} (the causal and no-bias attention fit TINY's GPT dk 32 and CLVP "
        "dim_head 64; every other shape took its plain version)")
    return launches


# ---------------------------------------------------------------------- (j)

# Limits of phase (j), each on the relative L2 error of the card against the
# port's f32 CPU path at the same weights (tests/test_torch_*.py hold the CPU
# path to the JAX package). Paths that the card runs in bf16 (the UniPC tail
# through the trunk kernels, the conditioning encoder through the no-bias
# kernel, DiffusionTts through the bias and resblock kernels) take phase
# (e)'s limits for the same kind of output; paths the card runs in f32 with
# TF32 off (the plain CLVP, as the JAX package serves it; the classifier,
# MelEncoder, PerceiverResampler and the Vocos variants, which reach no
# kernel) take 1e-4, summation order only; imdct(mdct(x)) is the largest
# |error| against x away from the edges, as tests/test_mdct.py holds JAX's.
SLICE7_TOL = {"unipc mel": 2e-2, "unipc wav": 3e-2, "unipc_bh1 mel": 2e-2,
              "unipc_bh1 wav": 3e-2, "plain clvp latents": 1e-4, "plain clvp sims": 1e-4,
              "classifier logits": 1e-4, "resnet + symexp head wav": 1e-4,
              "resnet + cos head wav": 1e-4, "imdct(mdct(x)) max abs": 1e-4,
              "conditioning encoder": 3e-2, "mel encoder": 1e-4, "perceiver": 1e-4,
              "diffusion_tts": 3e-2}
# the kernels of the serving path that a UniPC call launches as a DPM call does
SAME_AS_DPM = ("vq_nearest", "decode_attention", "flash_attention_bias",
               "flash_attention_causal", "scale_shift_resblock")
# DiffusionTts's contextual_attn at a 5 s conditioning mel: 469 frames, two
# stride-2 convs → T=118, 1024 channels / 16 heads → D=64, with a bias
CTX_SHAPE = (1, 118, 16, 64)


def slice7_config(cfg):
    """cfg with the UniPC sampler and the plain-Transformer CLVP."""
    return dataclasses.replace(
        cfg, diffusion=dataclasses.replace(cfg.diffusion, sampler="unipc"),
        clvp=dataclasses.replace(cfg.clvp, use_xformers=False))


def _typical_decode(gpt_card, gpt_cpu, text, prompt, steps: int, g) -> dict:
    """inference_speech with typical sampling on the card's GPT (4 rows,
    shared Gumbel draws), then the card's codes teacher-forced through both
    GPTs: at each draw the two kept sets, and the CPU's token against the
    card's where the kept sets are equal and the CPU's winning margin
    exceeds twice the warped logits' largest difference (the draw is
    decided)."""
    from ttts_tpu_torch.models.gpt import inference_speech
    from ttts_tpu_torch.models.sampling import SamplingParams, sample_gumbel, warp_logits

    sp = SamplingParams(top_p=0.8, temperature=0.8, repetition_penalty=2.0,
                        typical_sampling=True)
    k, v = 4, gpt_cpu.cfg.number_mel_codes
    text_b, prompt_b = text.expand(k, -1), prompt.expand(k, -1)
    gumbel = sample_gumbel((steps, k, v), g)
    with torch.no_grad():
        codes = inference_speech(gpt_card, text_b.cuda(), prompt_b.cuda(), steps, sp,
                                 gumbel.cuda()).cpu()
        n = text.shape[1] + 2 + prompt.shape[1] + 1
        warped = {}
        for name, model in (("cuda", gpt_card), ("cpu", gpt_cpu)):
            tb, pb = text_b.to(name), prompt_b.to(name)
            cache, logits, _, off = model.prefill(tb, pb, n + steps)
            counts_ = torch.zeros(k, v, dtype=torch.int32, device=name)
            counts_.scatter_add_(1, pb, torch.ones_like(pb, dtype=torch.int32))
            rows, out = torch.arange(k, device=name), []
            for i in range(steps):
                out.append(warp_logits(logits, counts_, sp).float().cpu())
                tok = codes[:, i].to(name)
                counts_[rows, tok] += 1
                if i + 1 < steps:
                    logits = model.decode_one(tok, cache, n + i, off + i)
            warped[name] = out
    stops = codes == gpt_cpu.cfg.stop_mel_token  # compare the draws before any row stops
    live = int(torch.where(stops.any(1), stops.int().argmax(1), steps).min())
    same_kept = decided = mism = 0
    for i in range(live):
        wg, wc = warped["cuda"][i], warped["cpu"][i]
        kg, kc = torch.isfinite(wg), torch.isfinite(wc)
        both = kg & kc
        err = float((wg - wc).abs()[both].max()) if both.any() else 0.0
        for r in range(k):
            if not torch.equal(kg[r], kc[r]):
                continue
            same_kept += 1
            top2 = torch.topk(wc[r] + gumbel[i, r], 2).values
            if float(top2[0] - top2[1]) > 2 * err:
                decided += 1
                mism += int(int(torch.argmax(wc[r] + gumbel[i, r])) != int(codes[r, i]))
    return {"draws": live * k, "same_kept": same_kept, "decided": decided, "mismatches": mism}


def phase_slice7(dpm_tts, per_fast: dict, card: str) -> dict:
    """(j) See the module docstring; `dpm_tts` is phase (d)'s TextToSpeech
    (DPM++, x-transformers CLVP), whose steady "fast" call launched
    `per_fast`. Returns the steady UniPC call's launches by kernel."""
    import copy

    from ttts_tpu_torch.api import cast_for_inference
    from ttts_tpu_torch.config import default_config
    from ttts_tpu_torch.models.classifier import AudioMiniEncoderWithClassifierHead
    from ttts_tpu_torch.models.conditioning import (ConditioningEncoder, MelEncoder,
                                                    PerceiverResampler)
    from ttts_tpu_torch.models.diffusion_tts_v1 import DiffusionTts
    from ttts_tpu_torch.models.sampling import apply_typical
    from ttts_tpu_torch.models.vocos import (IMDCTCosHead, IMDCTSymExpHead,
                                             VocosResNetBackbone)
    from ttts_tpu_torch.ops.mdct import imdct, mdct

    cfg = slice7_config(default_config())
    t0 = time.perf_counter()
    tts = make_tts("cuda", cfg)
    log(f"(j) init: TextToSpeech(default_config(), sampler unipc, plain CLVP, cuda) "
        f"{time.perf_counter() - t0:.2f} s")
    voice = synthetic_voice(5.0, 44100, seed=2)
    sr_out = tts.cfg.acoustic_mel.sample_rate
    tts.profile_stages = dpm_tts.profile_stages = True
    sites, undo = _watch_call_sites(tts.gpt, tts.clvp, tts.diffusion)
    tts.tts(TEXT, voice, 44100, max_generate_length=400, seed=0)  # warm-up
    # steady "fast" calls in turns, DPM (phase (d)'s), UniPC, UniPC, DPM, in
    # one process: the host sets these walls (PERF.md §5), so only calls
    # made side by side compare
    walls, stages, launches = {"dpm": [], "unipc": []}, {"dpm": [], "unipc": []}, None
    for kind in ("dpm", "unipc", "unipc", "dpm"):
        t = tts if kind == "unipc" else dpm_tts
        for n in sites:
            sites[n] = 0
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        wav = t.tts(TEXT, voice, 44100, max_generate_length=400, seed=1)
        torch.cuda.synchronize()
        walls[kind].append(time.perf_counter() - t0)
        stages[kind].append(t.last_stage_times)
        _check_wavs(t, [wav])
        if kind == "unipc":
            launches, calls = counts(), dict(sites)
    undo()
    audio_s = wav.shape[0] / sr_out
    for kind, name in (("dpm", "DPM++(2M), x-transformers CLVP"),
                       ("unipc", "UniPC, plain CLVP")):
        mean = {k: np.mean([st[k] for st in stages[kind]]) * 1e3 for k in stages[kind][0]}
        log(f"(j) steady tts (fast) with {name}: walls "
            f"{', '.join(f'{w:.3f}' for w in walls[kind])} s, RTF "
            f"{np.mean(walls[kind]) / audio_s:.4f} ({audio_s:.2f} s audio) | mean stage ms: "
            + " ".join(f"{k} {v:.1f}" for k, v in mean.items()))
    log(f"(j) launches in a steady UniPC call {launches}; its call-site calls {calls}; "
        f"phase (d)'s steady DPM fast call {per_fast}")
    # the rerank of the last call's 4 candidates alone, each CLVP flavour
    ids = np.asarray(tts.tok.encode(TEXT), np.int64)
    text4 = torch.as_tensor(np.pad(ids, (0, -len(ids) % 16)), device="cuda")[None].expand(4, -1)
    cand = torch.as_tensor(tts.last_codes, device="cuda")
    with torch.no_grad():
        for name, clvp in (("plain, f32", tts.clvp), ("x-transformers, bf16", dpm_tts.clvp)):
            busy, n, top = _device_busy(lambda: clvp(text4, cand))
            log(f"(j) CLVP rerank ({name}) of 4 x {cand.shape[1]} codes: device busy "
                f"{busy:.2f} ms in {n} launches (torch.profiler, one call; {card}); largest: "
                + ", ".join(f"{k[:40]} {us / 1e3:.2f} ms x{c}" for k, (c, us) in top))
    bad = {n: (launches[n], calls[n]) for n in KERNELS if launches[n] != calls[n]}
    bad.update({n: (launches[n], per_fast[n]) for n in SAME_AS_DPM
                if launches[n] != per_fast[n] or launches[n] == 0})
    if bad or launches["flash_attention_nobias"]:
        raise AssertionError(f"(j) launches (launches, calls or DPM's): {bad}; no-bias "
                             f"launches {launches['flash_attention_nobias']} (want 0)")

    cpu = make_tts("cpu", cfg)
    g = torch.Generator().manual_seed(13)
    errs, ms = {}, {}
    voice1 = synthetic_voice(1.0, 44100, seed=3)
    codes_c, refer = cpu.get_conditioning(voice1, 44100)
    ids = np.asarray(cpu.tok.encode(TEXT), np.int64)
    text = torch.as_tensor(np.pad(ids, (0, -len(ids) % 16)))[None]
    prompt = torch.nn.functional.pad(codes_c, (0, -codes_c.shape[1] % 16))
    codes = torch.randint(0, 1024, (1, 32), generator=g)
    noise = torch.randn(1, 128, 100, generator=g)
    for sampler in ("unipc", "unipc_bh1"):
        tts.cfg = cpu.cfg = dataclasses.replace(
            cfg, diffusion=dataclasses.replace(cfg.diffusion, sampler=sampler))
        mel_g, wav_g = tts.tail(text.cuda(), codes.cuda(), [32], refer.cuda(), noise.cuda(), 10)
        mel_c, wav_c = cpu.tail(text, codes, [32], refer, noise, 10)
        errs[f"{sampler} mel"] = rel_err(mel_g, mel_c)
        errs[f"{sampler} wav"] = rel_err(wav_g, wav_c)
    tts.cfg = cpu.cfg = cfg
    with torch.no_grad():
        text2, speech = text.expand(2, -1), torch.randint(0, 1024, (2, 64), generator=g)
        lat_g = tts.clvp.latents(text2.cuda(), speech.cuda())
        lat_c = cpu.clvp.latents(text2, speech)
        errs["plain clvp latents"] = max(rel_err(a, b) for a, b in zip(lat_g, lat_c))
        sims_g, sims_c = tts.clvp(text2.cuda(), speech.cuda()), cpu.clvp(text2, speech)
        errs["plain clvp sims"] = float((sims_g.cpu() - sims_c).abs().max()
                                        / cpu.clvp.temperature.exp())
        logits = torch.randn(4, 1026, generator=g) * 3
        kept_mism = int((torch.isfinite(apply_typical(logits.cuda(), 0.9)).cpu()
                         != torch.isfinite(apply_typical(logits, 0.9))).sum())
    # the serving GPT (bf16, decode kernel) and an f32 copy of the CPU's on
    # the card (plain attention), each against the f32 CPU path
    gpt32 = copy.deepcopy(cpu.gpt).cuda()
    dec = {name: _typical_decode(m, cpu.gpt, text, prompt, 32, g)
           for name, m in (("bf16", tts.gpt), ("f32", gpt32))}
    del gpt32

    # the modules callers construct directly, at default_config() widths, seeded
    _, mel5 = tts.get_conditioning(voice, 44100)  # the 5 s voice's mel (1, 469, 100)
    mel5 = mel5.float().cpu()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(5)
        mods = {"classifier": nonzero_proj_out(
                    AudioMiniEncoderWithClassifierHead(cfg.classifier)),
                "backbone": VocosResNetBackbone(cfg.vocos),
                "symexp": IMDCTSymExpHead(cfg.vocos.dim, 2 * cfg.vocos.hop_length),
                "cos": IMDCTCosHead(cfg.vocos.dim, 2 * cfg.vocos.hop_length),
                "conditioning_encoder": nonzero_proj_out(ConditioningEncoder(100, 512, 6, 8)),
                "mel_encoder": MelEncoder(512, 100),
                "perceiver": PerceiverResampler(512),
                "diffusion_tts": nonzero_proj_out(DiffusionTts())}
    cards = {}
    for name, m in mods.items():
        m.eval().requires_grad_(False)
        cards[name] = copy.deepcopy(m).cuda()
    for name in ("conditioning_encoder", "diffusion_tts"):  # bf16, as served
        cast_for_inference(cards[name])
    mel_clf = torch.randn(2, cfg.classifier.pad_to_mel_frames, 100, generator=g)
    x_dt = torch.randn(1, 500, 100, generator=g)
    ts_dt = torch.tensor([500.0])
    codes_dt = torch.randint(0, 8193, (1, 125), generator=g)
    x_pr = torch.randn(1, 118, 512, generator=g)
    mask_pr = torch.arange(118)[None] < 100
    frame = 2 * cfg.vocos.hop_length
    wav24 = torch.from_numpy(voice[: 120000 // frame * frame].copy())[None]
    calls = {  # name → (card call, CPU call)
        "classifier logits": (lambda m, d: m["classifier"](mel_clf.to(d))),
        "resnet + symexp head wav": (lambda m, d: m["symexp"](m["backbone"](mel5.to(d)))),
        "resnet + cos head wav": (lambda m, d: m["cos"](m["backbone"](mel5.to(d)))),
        "conditioning encoder": (lambda m, d: m["conditioning_encoder"](mel5.to(d))),
        "mel encoder": (lambda m, d: m["mel_encoder"](mel5.to(d))),
        "perceiver": (lambda m, d: m["perceiver"](x_pr.to(d), mask_pr.to(d))),
        "diffusion_tts": (lambda m, d: m["diffusion_tts"](
            x_dt.to(d), ts_dt.to(d), codes_dt.to(d), mel5.to(d))),
    }
    # the launches each call must make: one per AttentionBlock of the bf16
    # modules (no bias in the conditioning encoder; DiffusionTts: 5
    # contextual at D=64, 3 code-converter, 3 integrator and 8 trunk blocks
    # at D=32) and one per ScaleShiftResBlock (3 + 8 + 3); the f32 modules
    # are outside every kernel's domain (the classifier's attention also by
    # D=128) and launch none
    want = {"conditioning encoder": {"flash_attention_nobias": 6},
            "diffusion_tts": {"flash_attention_bias": 19, "scale_shift_resblock": 14}}
    launched = {}
    with torch.no_grad():
        for name, call in calls.items():
            torch.cuda.synchronize()
            reset_counts()
            out_g = call(cards, "cuda")
            torch.cuda.synchronize()
            launched[name] = {n: c for n, c in counts().items() if c}
            if not torch.isfinite(out_g).all():
                raise AssertionError(f"(j) {name}: non-finite output on the card")
            errs[name] = rel_err(out_g, call(mods, "cpu"))
            ms[name] = median_ms(lambda: call(cards, "cuda"), reps=5, warmup=1)
        y = imdct(mdct(wav24.cuda(), frame), frame).cpu()
        inner = slice(frame, wav24.shape[1] - frame)
        errs["imdct(mdct(x)) max abs"] = float((y[:, inner] - wav24[:, inner]).abs().max())
    log(f"(j) card vs f32 CPU path, default_config widths: " + ", ".join(
        f"{k} {v:.3e} (tol {SLICE7_TOL[k]})" for k, v in errs.items()))
    log(f"(j) apply_typical on seeded f32 logits (4, 1026), mass 0.9: kept-set mismatches "
        f"card vs CPU {kept_mism} (tol 0); typical decode of 32 steps x 4 rows, teacher-"
        f"forced, card GPT vs the f32 CPU GPT: " + "; ".join(
            f"{k}: {d['draws']} draws, kept sets equal in {d['same_kept']}, decided in "
            f"{d['decided']}, token mismatches among those {d['mismatches']} (tol 0)"
            for k, d in dec.items()) + " (f32: kept sets equal in >= 90% of the draws)")
    log(f"(j) kernels launched by each module call: {launched} (want {want}, none "
        f"elsewhere); median ms on the card "
        f"(CUDA events, 5 calls; {card}): " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))
    bad = [k for k, v in errs.items() if not v <= SLICE7_TOL[k]]
    bad += [f"{k} launches {launched[k]}" for k in calls if launched[k] != want.get(k, {})]
    if (kept_mism or dec["bf16"]["mismatches"] or dec["f32"]["mismatches"]
            or dec["f32"]["same_kept"] < 0.9 * dec["f32"]["draws"]):
        bad.append(f"typical: kept-set mismatches {kept_mism}, decode {dec}")
    if bad:
        raise AssertionError(f"(j) the card disagrees with the CPU path: {bad}")
    return launches


# ---------------------------------------------------------------------- (e)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float((a - b).norm() / b.norm())


def phase_reference(gpu):
    # measured on an H100 80GB HBM3 (700 W): refer_mel 1.8e-7, logits 9.8e-3,
    # clvp_latents 7.7e-3, sims 7.3e-4, mel 6.1e-3, wav 7.3e-3 (PERF.md); the
    # CLVP limits were set before their first reading. A wrong kernel gives
    # errors of order 1. "sims" is over exp(temperature), the largest a
    # similarity can be (a cosine of random latents is near 0 and has no
    # relative precision of its own)
    tol = {"refer_mel": 1e-5, "logits": 3e-2, "clvp_latents": 3e-2, "sims": 1e-2,
           "mel": 2e-2, "wav": 3e-2}
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

        text2, speech = text.expand(2, -1), torch.randint(0, 1024, (2, 64), generator=g)
        lat_g = gpu.clvp.latents(text2.cuda(), speech.cuda())
        lat_c = cpu.clvp.latents(text2, speech)
        errs["clvp_latents"] = max(rel_err(a, b) for a, b in zip(lat_g, lat_c))
        sims_g, sims_c = gpu.clvp(text2.cuda(), speech.cuda()), cpu.clvp(text2, speech)
        errs["sims"] = float((sims_g.cpu() - sims_c).abs().max() / cpu.clvp.temperature.exp())

    codes = torch.randint(0, 1024, (1, 32), generator=g)
    noise = torch.randn(1, 128, 100, generator=g)
    mel_g, wav_g = gpu.tail(text.cuda(), codes.cuda(), [32], refer.cuda(), noise.cuda(), 10)
    mel_c, wav_c = cpu.tail(text, codes, [32], refer, noise, 10)
    errs["mel"], errs["wav"] = rel_err(mel_g, mel_c), rel_err(wav_g, wav_c)
    finite = all(torch.isfinite(t).all() for t in (mel_g, wav_g, sims_g))
    log(f"(e) card vs f32 CPU path, default_config, 1 s prompt, CLVP B=2 speech T=64, "
        f"32 codes, 10 steps: prompt-code mismatches {mism}/{codes_c.numel()} (tol 0); "
        "relative errors " + ", ".join(f"{k} {v:.3e} (tol {tol[k]})" for k, v in errs.items()))
    bad = [k for k, v in errs.items() if not v <= tol[k]]
    if mism or bad or not finite:
        raise AssertionError(f"card path disagrees with the CPU path: {bad}, "
                             f"{mism} code mismatches, finite={finite}")


# ---------------------------------------------------------------------- (g)

# Copies of csrc with faults planted, one fault per phase-(c) check whose
# limit is shown here, each read at a shape the other faults of its copy
# leave alone. Copy 0: in the attention kernel, the causal mask letting one
# key past the diagonal (T=192, no bias, no ragged edge), the ragged-edge key
# mask removed (no bias, T=32, no diagonal) and the strip segment read one
# diagonal off (bias, T=128); in the cluster decode kernel, the partials of
# ranks 1-7 dropped from rank 0's merge (B=4, pos 562); in the resblock,
# conv3's taps read through a 2-D map over B*T rows, so row -1 / T comes
# from the neighbouring batch and not from the zero fill (B=2, T=1024, no
# ragged tile), and the GroupNorm partials of h's ragged last 128-row tile
# dropped from the merge (B=1, T=1600: no neighbouring batch; x's 32-row
# partials have no ragged one there); the GroupNorm scale g dropped from
# gn_qkv's multiply-add (B=2, T=1024, x shifted and scaled); in the VQ
# kernel, ties resolved to the higher index (the key's index bits inverted). Copy 1: the FiLM scale a2 dropped, which
# every resblock call meets; the mean dropped from gn_qkv's multiply-add;
# rank 7's codes dropped from the VQ cluster merge. Copy 2: ||e||^2 dropped
# from the VQ distance (each VQ fault meets every VQ call, so each has its
# own copy).
FAULTS = (  # (copy, file, correct text, planted text)
    (0, "attention.cu", "k0 == q0 && j > i)", "k0 == q0 && j > i + 1)"),
    (0, "attention.cu", "return k0 + j < T ? x : -INFINITY;", "return x;"),
    (0, "attention.cu", "const int sb = k0 + 2 * t4 - row0 + FA_BQ - 1;",
     "const int sb = k0 + 2 * t4 - row0 + FA_BQ;"),
    (0, "decode_attention.cu", "const float w = exp2f(mr[r] - mx);",
     "const float w = r ? 0.f : exp2f(mr[r] - mx);"),
    (0, "resblock.cu",
     "const cuuint64_t conv_dims[3] = {(cuuint64_t)C, (cuuint64_t)T, (cuuint64_t)B};",
     "const cuuint64_t conv_dims[3] = {(cuuint64_t)C, (cuuint64_t)T * B, 1};"),
    (0, "resblock.cu", "m0 + tap - 1, b);", "b * T + m0 + tap - 1, 0);"),
    (0, "resblock.cu", "const int s_end = S;", "const int s_end = T / rows;"),
    (0, "resblock.cu", "m[e] = s_rstd[g] * sc[c];", "m[e] = s_rstd[g];"),
    (0, "vq.cu", "return ((u64)ord << 32) | (unsigned)j;",
     "return ((u64)ord << 32) | ~(unsigned)j;"),
    (0, "vq.cu", "return (int)(k & 0xffffffffull);", "return (int)~(unsigned)(k & 0xffffffffull);"),
    (1, "resblock.cu", "mul[e] = rs * scb[c];", "mul[e] = FILM ? rs : rs * scb[c];"),
    (1, "resblock.cu", "a[e] = sh[c] - s_mean[g] * m[e];", "a[e] = sh[c];"),
    (1, "vq.cu", "for (int r = 1; r < VQ_RANKS; ++r)", "for (int r = 1; r < VQ_RANKS - 1; ++r)"),
    (2, "vq.cu", "vq_key(nk - 2.f * acc[i][k], j)", "vq_key(-2.f * acc[i][k], j)"),
)
COPIES = 1 + max(f[0] for f in FAULTS)


def _planted_readings(copy: int, g) -> list:
    """(what, metric, limit, compare(...)) of each fault of one planted copy,
    run on that copy's library."""
    from ttts_tpu_torch.ops.cuda.attention import flash_attention_plain
    from ttts_tpu_torch.ops.cuda.decode_attention import decode_attention_plain
    from ttts_tpu_torch.ops.cuda.resblock import (fused_gn_qkv_plain,
                                                  fused_scale_shift_resblock_plain)

    fn, res = wrapper("flash_attention_bias"), wrapper("scale_shift_resblock")
    bf = torch.bfloat16

    def resblock(b, t):
        args = _resblock_args(g, b, t, 512)
        return compare(res(*args), fused_scale_shift_resblock_plain(*args))

    def gn_qkv():  # x shifted and scaled: GN's mean and scale matter
        args = _gn_qkv_args(g, 2, 1024, 512, 1.0, 2.0)
        return compare(wrapper("gn_qkv")(*args), fused_gn_qkv_plain(*args))

    def vq():
        x, cb = _vq_inputs(g, 500, 1024)
        return _vq_reading(x, cb, wrapper("vq_nearest")(x, cb))

    if copy == 2:
        return [("||e||^2 dropped from the VQ distance, N=500 bins=1024", "wrong", 0, vq())]
    if copy == 1:
        return [("FiLM scale a2 dropped, resblock B=2 T=1600 C=512", "excess", RES_TOL,
                 resblock(2, 1600)),
                ("GN mean dropped from the multiply-add, gn_qkv B=2 T=1024 C=512", "excess",
                 RES_TOL, gn_qkv()),
                ("rank 7's codes dropped from the VQ cluster merge, N=500 bins=1024", "wrong",
                 0, vq())]
    (q, k, v), (q2, k2, v2), (q3, k3, v3) = (
        torch.randn(b, t, 3, h, d, generator=g, device="cuda").to(bf).unbind(2)
        for b, t, h, d in ((4, 192, 8, 64), (4, 32, 16, 64), (2, 128, 16, 32)))
    strip = torch.randn(16, 2 * 128 - 1, generator=g, device="cuda")
    dec = [torch.randn(*s, generator=g, device="cuda").to(bf)
           for s in [(4, 8, 64)] * 3 + [(4, 8, 563, 64)] * 2]
    ref = [x.float() for x in dec]  # the plain version on f32 copies, as phase (c)
    return [
        ("causal mask off by one key, B=4 T=192 H=8 D=64", "rel_l2", ATTN_TOL,
         compare(fn(q, k, v, causal=True), flash_attention_plain(q, k, v, causal=True))),
        ("ragged-edge key mask removed, no bias, B=4 T=32 H=16 D=64", "rel_l2", ATTN_TOL,
         compare(fn(q2, k2, v2), flash_attention_plain(q2, k2, v2))),
        ("strip segment read one diagonal off, bias, B=2 T=128 H=16 D=32", "rel_l2", ATTN_TOL,
         compare(fn(q3, k3, v3, strip), flash_attention_plain(q3, k3, v3, strip))),
        ("ranks 1-7 dropped from the decode merge, B=4 pos 562", "excess", DECODE_TOL,
         compare(wrapper("decode_attention")(*dec, 562), decode_attention_plain(*ref, 562))),
        ("conv3 taps through a 2-D map over B*T rows, resblock B=2 T=1024 C=512", "excess",
         RES_TOL, resblock(2, 1024)),
        ("h's ragged last tile's GN partials dropped, resblock B=1 T=1600 C=512", "excess",
         RES_TOL, resblock(1, 1600)),
        ("GN scale g dropped from the multiply-add, gn_qkv B=2 T=1024 C=512", "excess",
         RES_TOL, gn_qkv()),
        ("VQ ties to the higher index, N=500 bins=1024", "wrong", 0, vq()),
    ]


def phase_planted() -> None:
    """Build the faulty copies apart, at once, and show that each limit
    fails its fault."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    from ttts_tpu_torch.ops.cuda import _build

    copies = [_build.BUILD_DIR.parent / f"planted_csrc{i}" for i in range(COPIES)]
    for planted in copies:
        shutil.rmtree(planted, ignore_errors=True)
        shutil.copytree(_build.CSRC, planted)
    for copy, name, good, bad in FAULTS:
        src = copies[copy] / name
        text = src.read_text()
        if text.count(good) != 1:
            raise AssertionError(f"planted fault: {good!r} not found once in {name}")
        src.write_text(text.replace(good, bad))
    csrc = _build.CSRC
    g = torch.Generator("cuda").manual_seed(6)
    readings = []
    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(copies)) as pool:
            list(pool.map(lambda d: _build.build(csrc=d), copies))
        build_s = time.perf_counter() - t0
        for i, planted in enumerate(copies):
            _build.CSRC = planted
            _build.library.cache_clear()
            readings += [(what, m[metric], metric, tol)
                         for what, metric, tol, m in _planted_readings(i, g)]
        torch.cuda.synchronize()
    finally:
        _build.CSRC = csrc
        _build.library.cache_clear()
        for planted in copies:
            shutil.rmtree(planted, ignore_errors=True)
    log(f"(g) planted faults ({len(copies)} copies of csrc, built apart at once in "
        f"{build_s:.2f} s): " + "; ".join(
            f"{what}: {metric} {val:.3e} (limit {tol})" for what, val, metric, tol in readings))
    passed = [what for what, val, _, tol in readings if not val > tol]
    if passed:
        raise AssertionError(f"a phase-(c) limit passes a planted fault: {passed}")


# ---------------------------------------------------------------------- (f)


def device_us(fn, reps: int = 20) -> str:
    """Device time per call of `fn` from torch.profiler: the total in us,
    then each device kernel's us and launches per call (a count below the
    wrapper's launches would show events the profiler dropped). Every `fn`
    here launches at least one device kernel per call, so a session that
    caught fewer than `reps` device events lost some and is taken again."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for attempt in range(1, 4):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_kernel = _by_kernel(prof)
        if sum(n for n, _ in by_kernel.values()) >= reps:
            break
    else:
        return "not measured (the profiler caught too few device events in 3 sessions)"
    total = sum(us for _, us in by_kernel.values()) / reps
    parts = ", ".join(f"{name[:28]} {us / reps:.1f} us x{n / reps:g}"
                      for name, (n, us) in by_kernel.items())
    again = f", session {attempt}" if attempt > 1 else ""
    return f"{total:.1f} us ({parts}{again})"


def _by_kernel(prof) -> dict:
    """{device kernel name[:60]: (launches, total us)}, largest total first."""
    by_kernel: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, us = by_kernel.get(e.name[:60], (0, 0.0))
            by_kernel[e.name[:60]] = (n + 1, us + e.time_range.elapsed_us())
    return dict(sorted(by_kernel.items(), key=lambda kv: -kv[1][1]))


def phase_profile(rows, tts) -> None:
    """Device time of each kernel and its plain version at the last
    phase-(c) shape, and the device's busy share of a steady tts call at the
    default preset "fast"."""
    for name in KERNELS:
        last = [r for r in rows if r["name"] == name][-1]
        lib = device_us(last["run_library"]) if last["run_library"] else "none"
        log(f"(f) {name}, device time per call at the last (c) shape: kernel "
            f"{device_us(last['run'])} | plain {device_us(last['run_plain'])} | library {lib}")
    b, t, h, d = CTX_SHAPE
    ctx = [r for r in rows if r["shape"].startswith(f"B={b} T={t} H={h} D={d} ")][0]
    log(f"(f) flash_attention_bias at DiffusionTts's contextual_attn shape {CTX_SHAPE}: "
        f"kernel {device_us(ctx['run'])} | plain {device_us(ctx['run_plain'])} | library "
        f"{device_us(ctx['run_library'])}")
    # the resblock's two GEMMs alone in bf16 through torch.matmul: a floor
    # for its tensor-core part, not a call of the same function
    g = torch.Generator("cuda").manual_seed(7)
    mats = [torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16)
            for shape in ((3200, 512), (512, 512), (3200, 1536), (1536, 512))]
    log(f"(f) note, the resblock's GEMMs alone (torch.matmul, bf16): 3200x512x512 "
        f"{device_us(lambda: mats[0] @ mats[1])} | 3200x1536x512 "
        f"{device_us(lambda: mats[2] @ mats[3])}")
    # floors of VQ and gn_qkv, their products alone through cuBLAS: VQ's
    # x @ cb.T in f32 (TF32 off, phase (a)) and gn_qkv's at B=4 T=1600
    xv, cbv = (torch.randn(*shape, generator=g, device="cuda") for shape in ((500, 192),
                                                                            (1024, 192)))
    qa, qw = (torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16)
              for shape in ((6400, 512), (512, 1536)))
    log(f"(f) note, floors: VQ's x @ cb.T alone (f32, TF32 off) 500x192x1024 "
        f"{device_us(lambda: xv @ cbv.T)} | gn_qkv's product alone (bf16) 6400x512x1536 "
        f"{device_us(lambda: qa @ qw)}")
    voice = synthetic_voice(5.0, 44100, seed=2)
    tts.profile_stages = False
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tts.tts(TEXT, voice, 44100, max_generate_length=400, seed=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy_ms, _, top = _device_busy(
        lambda: tts.tts(TEXT, voice, 44100, max_generate_length=400, seed=1), top=12)
    busy = busy_ms / 1e3
    log(f"(f) steady tts call (fast): wall {wall:.3f} s without the profiler, device busy "
        f"{busy:.3f} s under it: busy share {busy / wall:.3f}")
    for name, (n, us) in top:
        log(f"(f)   {us / 1e3:9.2f} ms {n:6d} launches  {name}")


# ---------------------------------------------------------------------- (k)

# Card (bf16 autocast over f32 weights) against the port's f32 CPU step at
# the same full width, weights, batch and injected draws: relative error of
# the loss and of the global grad norm, and the cosine of each gradient
# tensor (the named trunk attention and resblock weights, and the least of
# all tensors). A tensor whose gradient is zero on one side and not on the
# other fails outright: that is a cut gradient. The limits are a few times
# the largest readings of three runs on an H100 80GB HBM3 at 700 W (GPT /
# diffusion: loss 1.2e-5 / 1.9e-4, grad norm 4.4e-4 / 1.2e-3, least cosine
# 0.99998 / 0.99958, least named cosine 0.99998 / 0.99991; PERF.md). The
# diffusion step's frozen-GPT latent (the causal kernel's output, on the
# card) is held to the CPU's at the limit phase (e) holds the same GPT's
# bf16 logits to.
TRAIN_TOL = {"loss_rel": 1e-3, "grad_norm_rel": 5e-3, "named_cos": 0.9995, "min_cos": 0.998,
             "latent_rel": 3e-2}
NOISE = 1e-6  # of the global grad norm: a tensor's gradient below it is zero analytically
TRAIN_STEPS, SAVE_FREQ, TRAIN_BATCH = 12, 6, 32


def _train_data(root, rows: int = 64, seed: int = 0) -> str:
    """A seeded manifest of `rows` pinyin texts with `.vq.npy` sidecars of
    200-600 codes and `.mel.npy` sidecars of 200-400 frames x 100."""
    from ttts_tpu_torch.data.manifest import save_sidecar, write_manifest

    rng = np.random.default_rng(seed)
    texts = [TEXT, TEXT2, "ta1 shuo1 ming2 tian1 hui4 xia4 yu3"]
    table = []
    for i in range(rows):
        path = str(root / f"utt{i:03d}.wav")
        save_sidecar(path, "vq", rng.integers(0, 1024, int(rng.integers(200, 601))))
        save_sidecar(path, "mel", (rng.standard_normal((int(rng.integers(200, 401)), 100))
                                   - 4.0).astype(np.float32))
        table.append({"text": texts[i % len(texts)], "path": path})
    write_manifest(root / "train.jsonl", table)
    return str(root / "train.jsonl")


def _run_trainer(make, what: str, tokens) -> dict:
    """Train the trainer `make()` builds to its end on the card, counting its
    kernel launches; → its history, launches, median step ms after 3
    warm-up steps and throughput: the tokens (frames) of every steady step
    over their summed seconds. A first run meets each bucket's batch
    shape for the first time (cuBLAS and SDPA pick their kernels, the
    allocator grows); a resumed run takes batches whose shapes the first
    run already met: its steps are the steady ones. Each step ends in a
    synchronise, so its seconds are the card's."""
    trainer = make()
    start = trainer.step
    work = []
    step_fn = trainer.step_fn

    def timed_step(state, batch, key):
        work.append(tokens(batch))
        metrics = step_fn(state, batch, key)
        torch.cuda.synchronize()
        return metrics

    trainer.step_fn = timed_step
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    trainer.train()
    launches = counts()
    hist = list(trainer.history)
    for h in hist:
        loss, norm = float(h["loss"]), float(h["grad_norm"])
        if not (math.isfinite(loss) and math.isfinite(norm)) or h["nonfinite_skipped"]:
            raise RuntimeError(f"(k) {what}: step {h['step']} loss {loss} grad norm {norm}")
    steady = hist[3:] if len(hist) > 3 else hist
    secs = [h["seconds"] for h in steady]
    ms, spread = float(np.median(secs)) * 1e3, (min(secs) * 1e3, max(secs) * 1e3)
    per_s = sum(work[len(hist) - len(steady):]) / sum(secs)
    log(f"(k) {what}: steps {start + 1}-{trainer.step}, loss "
        f"{float(hist[0]['loss']):.4f} -> {float(hist[-1]['loss']):.4f}, grad norms "
        f"{min(float(h['grad_norm']) for h in hist):.3f}-"
        f"{max(float(h['grad_norm']) for h in hist):.3f}, all finite | {len(steady)} steady "
        f"steps: median {ms:.2f} ms ({spread[0]:.2f}-{spread[1]:.2f}) | peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return {"trainer": trainer, "launches": launches, "ms": ms, "spread": spread,
            "per_s": per_s, "steps": len(hist)}


def _grad_reading(names, card, cpu) -> dict:
    """Per-tensor cosines of card and CPU gradients, and the global norms.
    A tensor whose CPU gradient is below NOISE of the global norm is zero
    analytically (e.g. an attention key bias, which the softmax cancels) and
    rounding noise on both sides: it is listed, not held to a cosine."""
    norm = lambda gs: math.sqrt(sum(float(g.double().square().sum()) for g in gs  # noqa: E731
                                    if g is not None))
    floor = NOISE * norm(cpu)
    cos, cut, noise = {}, [], []
    for n, a, b in zip(names, card, cpu):
        if a is None and b is None:
            continue  # a layer both sides skipped (layer drop)
        a = torch.zeros_like(b) if a is None else a.detach().double().cpu()
        b = torch.zeros_like(a) if b is None else b.detach().double()
        na, nb = float(a.norm()), float(b.norm())
        if nb <= floor:
            noise.append(n)
        elif na == 0.0:
            cut.append(n)
        else:
            cos[n] = float((a * b).sum() / (na * nb))
    return {"cos": cos, "cut": cut, "noise": noise, "norm_card": norm(card),
            "norm_cpu": norm(cpu)}


def _hold_train(what: str, loss_card, loss_cpu, reading, named) -> None:
    lrel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    nrel = abs(reading["norm_card"] - reading["norm_cpu"]) / reading["norm_cpu"]
    cos = reading["cos"]
    worst = min(cos, key=cos.get)
    named_cos = {n: cos[n] for n in named if n in cos}
    log(f"(k) {what}, card vs f32 CPU: loss {loss_card:.6f} vs {loss_cpu:.6f}, rel "
        f"{lrel:.3e} (tol {TRAIN_TOL['loss_rel']}) | grad norm {reading['norm_card']:.5f} vs "
        f"{reading['norm_cpu']:.5f}, rel {nrel:.3e} (tol {TRAIN_TOL['grad_norm_rel']}) | "
        f"least cosine of {len(cos)} tensors {cos[worst]:.5f} ({worst}; tol "
        f"{TRAIN_TOL['min_cos']}) | cut gradients {reading['cut'] or 'none'} | zero "
        f"analytically (below {NOISE} of the norm): {reading['noise'] or 'none'}")
    for n, c in named_cos.items():
        log(f"(k)   cosine {c:.5f} {n} (tol {TRAIN_TOL['named_cos']})")
    bad = (reading["cut"] or lrel > TRAIN_TOL["loss_rel"] or nrel > TRAIN_TOL["grad_norm_rel"]
           or cos[worst] < TRAIN_TOL["min_cos"] or len(named_cos) != len(named)
           or any(c < TRAIN_TOL["named_cos"] for c in named_cos.values()))
    if bad:
        raise RuntimeError(f"(k) {what}: the card's step disagrees with the CPU's")


def _compare_gpt(cfg, sd, batch) -> None:
    """One GPT loss and its gradients on the card (bf16) and the CPU (f32)."""
    import copy

    from ttts_tpu_torch.models.gpt import UnifiedVoice
    from ttts_tpu_torch.train.steps import autocast, gpt_loss

    cpu = UnifiedVoice(dataclasses.replace(cfg.gpt, dropout=0.0))
    cpu.load_state_dict(sd)
    card = copy.deepcopy(cpu).cuda().train()
    cpu.train()
    out = {}
    for name, model, dev in (("card", card, "cuda"), ("cpu", cpu, "cpu")):
        b = {k: v.to(dev) for k, v in batch.items()}
        with autocast(torch.device(dev), torch.bfloat16 if dev == "cuda" else None):
            loss, _, _ = gpt_loss(model, b, cfg.train.text_weight, cfg.train.mel_weight)
        out[name] = (loss.item(), torch.autograd.grad(loss, list(model.parameters()),
                                                      allow_unused=True))
    names = [n for n, _ in cpu.named_parameters()]
    named = [f"gpt.h.{i}.attn.{w}.weight" for i in range(cfg.gpt.layers)
             for w in ("c_attn", "c_proj")]
    _hold_train("GPT step", out["card"][0], out["cpu"][0],
                _grad_reading(names, out["card"][1], out["cpu"][1]), named)


def _compare_diffusion(cfg, gpt_sd, net_sd, batch) -> None:
    """One diffusion loss and its gradients on the card (bf16, the frozen
    GPT's latent through the causal kernel) and the CPU (f32), on the same
    injected draws, with the attention output projections made non-zero
    (zero at init, they would zero every qkv gradient)."""
    import copy

    from ttts_tpu_torch.diffusion.gaussian import GaussianDiffusion, get_named_beta_schedule
    from ttts_tpu_torch.models.diffusion_net import AA_diffusion, DiffusionLayer
    from ttts_tpu_torch.models.gpt import UnifiedVoice
    from ttts_tpu_torch.train.steps import autocast, diffusion_draws, diffusion_loss, frozen_latent

    diffuser = GaussianDiffusion(betas=get_named_beta_schedule(
        cfg.diffusion.noise_schedule, cfg.diffusion.trained_timesteps))
    gpt_cpu = UnifiedVoice(cfg.gpt)
    gpt_cpu.load_state_dict(gpt_sd)
    gpt_cpu.requires_grad_(False)
    gpt_card = copy.deepcopy(gpt_cpu).cuda()
    net_cpu = AA_diffusion(cfg.diffusion_net)
    net_cpu.load_state_dict(net_sd)
    nonzero_proj_out(net_cpu)
    net_card = copy.deepcopy(net_cpu).cuda().train()
    net_cpu.train()
    draws = diffusion_draws(5, batch["mel"].shape, diffuser.num_timesteps, len(net_cpu.layers),
                            cfg.train.unconditioned_percentage, cfg.diffusion_net.layer_drop,
                            torch.device("cpu"))
    out = {}
    for name, net, gpt, dev in (("card", net_card, gpt_card, "cuda"),
                                ("cpu", net_cpu, gpt_cpu, "cpu")):
        amp = torch.bfloat16 if dev == "cuda" else None
        b = {k: v.to(dev) for k, v in batch.items()}
        d = {k: (v.to(dev) if torch.is_tensor(v) else v) for k, v in draws.items()}
        reset_counts()
        latent = frozen_latent(gpt, b, amp)
        with autocast(torch.device(dev), amp):
            loss, _, _ = diffusion_loss(net, diffuser, b, latent, d)
        out[name] = (loss.item(), torch.autograd.grad(loss, list(net.parameters()),
                                                      allow_unused=True), counts(), latent)
    if out["card"][2]["flash_attention_causal"] != cfg.gpt.layers:
        raise RuntimeError(f"(k) the card's frozen GPT launched {out['card'][2]}")
    lat = rel_err(out["card"][3], out["cpu"][3])
    finite = bool(torch.isfinite(out["card"][3]).all())
    log(f"(k) frozen GPT latent {tuple(out['cpu'][3].shape)}, card (bf16, {cfg.gpt.layers} "
        f"causal launches) vs f32 CPU: relative error {lat:.3e} (tol "
        f"{TRAIN_TOL['latent_rel']}), finite {finite}")
    if not (lat <= TRAIN_TOL["latent_rel"] and finite):
        raise RuntimeError("(k) the card's frozen GPT latent disagrees with the CPU's")
    names = [n for n, _ in net_cpu.named_parameters()]
    trunk = [i for i, m in enumerate(net_cpu.layers) if isinstance(m, DiffusionLayer)]
    named = [f"layers.{i}.{w}.weight" for i in trunk
             for w in ("attn.qkv", "attn.proj_out", "resblk.in_layers.2", "resblk.out_layers.3")
             if draws["layer_keep"][i] or i in (0, len(net_cpu.layers) - 1)]
    _hold_train("diffusion step", out["card"][0], out["cpu"][0],
                _grad_reading(names, out["card"][1], out["cpu"][1]), named)


class _CausalShapes:
    """Within the block, the (B, T, H, D) of every causal kernel launch (a
    spy in place of attention.flash_attention, which attention.attend looks
    up at each call; it shares the wrapper's launch counts)."""

    def __enter__(self):
        from ttts_tpu_torch.ops.cuda import attention

        self.shapes, self.mod, self.fn = set(), attention, attention.flash_attention

        def spy(q, k, v, strip=None, causal=False):
            if causal and strip is None:
                self.shapes.add(tuple(q.shape))
            return self.fn(q, k, v, strip, causal)

        spy.launches = self.fn.launches
        attention.flash_attention = spy
        return self

    def __exit__(self, *exc):
        self.mod.flash_attention = self.fn


def _check_training_attention(rows, shapes) -> None:
    """The causal kernel against its plain version at the largest shape the
    diffusion train step gave it (the frozen GPT over a batch of 32), as
    views of the GPT's fused [q; k; v] projection, held at ATTN_TOL and
    timed as phase (c) times the other shapes."""
    from ttts_tpu_torch.ops.cuda.attention import flash_attention_plain

    b, t, h, d = max(shapes, key=lambda s: (s[0] * s[1], s))
    fn = wrapper("flash_attention_causal")
    g = torch.Generator("cuda").manual_seed(12)
    qkv = torch.randn(b, t, 3 * h * d, generator=g, device="cuda").to(torch.bfloat16)
    q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].reshape(b, t, h, d) for i in range(3))
    got, want = fn(q, k, v, causal=True), flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    qt, kt, vt = (z.transpose(1, 2) for z in (q, k, v))
    log(f"(k) causal kernel shapes of the diffusion train step: {sorted(shapes)}")
    _timed(rows, "flash_attention_causal", f"B={b} T={t} H={h} D={d} bf16 (diffusion train "
           "step)", compare(got, want), "rel_l2", ATTN_TOL,
           partial(fn, q, k, v, causal=True),
           partial(flash_attention_plain, q, k, v, causal=True),
           partial(torch.nn.functional.scaled_dot_product_attention, qt, kt, vt,
                   is_causal=True), _attention_work(b, t, h, d, False, True))
    row = rows[-1]
    log(f"(k) device time at that shape (torch.profiler): kernel {device_us(row['run'])} | "
        f"plain {device_us(row['run_plain'])} | SDPA {device_us(row['run_library'])}")


def _raw_wrappers_refuse_grad() -> None:
    """Each raw kernel wrapper raises on an input that requires grad under
    grad mode (the dispatches take the plain version there)."""
    from ttts_tpu_torch.ops.cuda import attention, decode_attention, resblock, vq

    g = torch.Generator("cuda").manual_seed(11)
    bf = dict(dtype=torch.bfloat16, device="cuda")
    q = torch.randn(1, 64, 2, 64, generator=g, device="cuda").to(torch.bfloat16)
    res = list(_resblock_args(g, 1, 64, 128))
    qkv = list(_gn_qkv_args(g, 1, 64, 128))
    x, cb = _vq_inputs(g, 40, 64)
    cache = [torch.zeros(1, 2, 8, 64, **bf) for _ in range(2)]
    rows = torch.randn(1, 2, 64, generator=g, device="cuda").to(torch.bfloat16)
    calls = {
        "flash_attention": lambda: attention.flash_attention(q.clone().requires_grad_(), q, q,
                                                             causal=True),
        "fused_scale_shift_resblock": lambda: resblock.fused_scale_shift_resblock(
            res[0].clone().requires_grad_(), *res[1:], groups=8),
        "fused_gn_qkv": lambda: resblock.fused_gn_qkv(qkv[0].clone().requires_grad_(),
                                                      *qkv[1:], groups=8),
        "vq_nearest": lambda: vq.vq_nearest(x.clone().requires_grad_(), cb),
        "decode_attention": lambda: decode_attention.decode_attention(
            rows.clone().requires_grad_(), rows, rows, *cache, 3),
    }
    for name, call in calls.items():
        try:
            call()
        except ValueError as e:
            if "requires grad" not in str(e):
                raise
        else:
            raise RuntimeError(f"(k) {name} launched on an input that requires grad")
    log(f"(k) raw wrappers on requires_grad inputs under grad mode: each raises ValueError "
        f"({', '.join(calls)})")


def _training_busy(trainer, batch, steps: int = 3):
    """(wall ms without the profiler, device-busy ms under it, launches) of
    `steps` more steps of `trainer` on one batch (warmed up first)."""
    b = trainer._put(batch)

    def run():
        for i in range(steps):
            trainer.step_fn(trainer.state, b, 2 + i)

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    busy_ms, n, _ = _device_busy(run)
    return wall, busy_ms, n


def phase_training(card: str, rows: list) -> dict:
    """(k) GPT and diffusion training at default_config() widths on the
    card: 12 steps each with checkpoints at 6 and 12 and a resume from 6,
    launch counts, step time, throughput, memory and busy share; the causal
    kernel at the largest shape the diffusion step gave it (a row added to
    `rows`); the card's step against the f32 CPU step; the raw wrappers'
    refusal of grad; the trained models exported and served."""
    import shutil
    import tempfile
    import pathlib

    from ttts_tpu_torch.api import TextToSpeech
    from ttts_tpu_torch.config import default_config
    from ttts_tpu_torch.data.datasets import DiffusionDataset, GptTtsDataset
    from ttts_tpu_torch.train import mains
    from ttts_tpu_torch.train.checkpoints import export_model

    t_phase = time.perf_counter()
    base = default_config()
    cfg = dataclasses.replace(base, train=dataclasses.replace(
        base.train, train_steps=TRAIN_STEPS, save_freq=SAVE_FREQ, batch_size=TRAIN_BATCH))
    root = pathlib.Path(tempfile.mkdtemp(prefix="ttts_train_"))
    try:
        manifest = _train_data(root)
        gpt_tokens = lambda b: float((b["text_lengths"] + 2 + b["wav_lengths"] // 1024  # noqa: E731
                                      + 2).sum())
        runs = {}
        runs["gpt"] = _run_trainer(lambda: mains.gpt_trainer(cfg, manifest, str(root / "gpt"), "cuda"),
                                   "GPT training", gpt_tokens)
        ckpts = runs["gpt"]["trainer"].ckpt.all_steps()
        if ckpts[-2:] != [SAVE_FREQ, TRAIN_STEPS]:
            raise RuntimeError(f"(k) GPT checkpoints {ckpts}")
        shutil.copytree(root / "gpt", root / "gpt_resume")
        (root / "gpt_resume" / "ckpt" / f"step_{TRAIN_STEPS:08d}.pt").unlink()
        again = _run_trainer(lambda: mains.gpt_trainer(cfg, manifest, str(root / "gpt_resume"),
                                                     "cuda"),
                             f"GPT resumed from step {SAVE_FREQ}", gpt_tokens)
        if again["steps"] != TRAIN_STEPS - SAVE_FREQ or again["trainer"].step != TRAIN_STEPS:
            raise RuntimeError("(k) the GPT resume did not continue from step 6 to 12")
        gpt_sd = mains.load_gpt_state_dict(root / "gpt")
        frames = lambda b: float(b["mel_lengths"].sum())  # noqa: E731
        with _CausalShapes() as causal:
            runs["diffusion"] = _run_trainer(
                lambda: mains.diffusion_trainer(cfg, manifest, gpt_sd, str(root / "diff"),
                                                "cuda"),
                "diffusion training", frames)
        shutil.copytree(root / "diff", root / "diff_resume")
        (root / "diff_resume" / "ckpt" / f"step_{TRAIN_STEPS:08d}.pt").unlink()
        again_d = _run_trainer(
            lambda: mains.diffusion_trainer(cfg, manifest, gpt_sd, str(root / "diff_resume"),
                                            "cuda"),
            f"diffusion resumed from step {SAVE_FREQ}", frames)
        if again_d["steps"] != TRAIN_STEPS - SAVE_FREQ:
            raise RuntimeError("(k) the diffusion resume did not continue from step 6 to 12")
        # launches: none in a GPT step, the frozen GPT's causal attention (one
        # per layer) in a diffusion step, nothing else
        per_step = {}
        for what, run in runs.items():
            want = {n: 0 for n in KERNELS}
            if what == "diffusion":
                want["flash_attention_causal"] = cfg.gpt.layers * run["steps"]
            if run["launches"] != want:
                raise RuntimeError(f"(k) {what} training launched {run['launches']}, "
                                   f"expected {want}")
            per_step[what] = {n: c / run["steps"] for n, c in run["launches"].items()}
            log(f"(k) {what} training launches over {run['steps']} steps: "
                f"{ {n: c for n, c in run['launches'].items() if c} or 'none'} (as expected)")
        _check_training_attention(rows, causal.shapes)
        log(f"(k) throughput over the resumed runs' steady steps (every shape met before; "
            f"their tokens over their summed seconds): GPT {again['per_s']:.0f} text+mel "
            f"tokens/s (median step {again['ms']:.2f} ms, {again['spread'][0]:.2f}-"
            f"{again['spread'][1]:.2f}), diffusion {again_d['per_s']:.0f} mel frames/s (median "
            f"step {again_d['ms']:.2f} ms, {again_d['spread'][0]:.2f}-"
            f"{again_d['spread'][1]:.2f}) | card {card}")
        gds, dds = GptTtsDataset(manifest), DiffusionDataset(manifest)
        gbatch = gds.collate([gds[i] for i in range(TRAIN_BATCH)])
        dbatch = dds.collate([dds[i] for i in range(TRAIN_BATCH)])
        for what, run, batch in (("GPT", runs["gpt"], gbatch),
                                 ("diffusion", runs["diffusion"], dbatch)):
            wall, busy, n = _training_busy(run["trainer"], batch)
            log(f"(k) {what}: 3 steady steps of batch {TRAIN_BATCH}: wall {wall:.1f} ms without "
                f"the profiler, device busy {busy:.1f} ms in {n} launches under it: busy share "
                f"{busy / wall:.3f}")
        small = lambda b: {k: torch.as_tensor(v[:4]).long() if v.dtype.kind in "iu"  # noqa: E731
                           else torch.as_tensor(v[:4]) for k, v in b.items()}
        net_sd = runs["diffusion"]["trainer"].state.model.state_dict()
        _compare_gpt(cfg, {k: v.cpu() for k, v in gpt_sd.items()}, small(gbatch))
        _compare_diffusion(cfg, {k: v.cpu() for k, v in gpt_sd.items()},
                           {k: v.cpu() for k, v in net_sd.items()}, small(dbatch))
        _raw_wrappers_refuse_grad()
        export_model("gpt", gpt_sd, root / "gpt.npz")
        export_model("diffusion", net_sd, root / "diffusion.npz")
        tts = TextToSpeech.from_checkpoints(cfg, gpt=root / "gpt.npz",
                                            diffusion=root / "diffusion.npz", device="cuda")
        wav = tts.tts(TEXT, synthetic_voice(3.0, 44100, seed=4), 44100, preset="ultra_fast",
                      max_generate_length=200, seed=1)
        if not (wav.size and np.isfinite(wav).all()):
            raise RuntimeError("(k) the trained models served a non-finite waveform")
        log(f"(k) export_release of both trained models -> TextToSpeech.from_checkpoints -> "
            f"tts 'ultra_fast': {wav.size} finite samples | phase (k) "
            f"{time.perf_counter() - t_phase:.1f} s")
        return per_step
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = phase_card()
    phase_build()
    rows = phase_kernels()
    tts, launches, per_fast, rtf = phase_end_to_end()
    phase_reference(tts)
    codec = phase_codec(card)
    phase_tiny()
    phase_profile(rows, tts)
    phase_planted()
    slice7 = phase_slice7(tts, per_fast, card)
    train = phase_training(card, rows)
    table = []
    for name, (_, _, _, source, replaces) in KERNELS.items():
        mine = [r for r in rows if r["name"] == name]
        last = mine[-1]  # the last shape measured: the path's largest
        table.append({"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": launches[name],
                      "launches_per_fast_call": per_fast[name],
                      "launches_codec_infer": codec[name],
                      "launches_unipc_fast_call": slice7[name],
                      "launches_gpt_train_step": train["gpt"][name],
                      "launches_diffusion_train_step": train["diffusion"][name],
                      "max_abs_err": max(r["max_abs_err"] for r in mine),
                      "ms": last["ms"], "plain_ms": last["plain_ms"],
                      "bound_ms": last["bound_ms"], "bound_by": last["bound_by"],
                      "library_ms": last["library_ms"]})
    log(f"total {time.perf_counter() - t_start:.1f} s; steady RTF fast {rtf['fast']:.4f}, "
        f"ultra_fast {rtf['ultra_fast']:.4f}")
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
