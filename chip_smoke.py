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
      torch.profiler; the causal kernel against its plain version at each
      shape the diffusion step gave it (ATTN_TOL; the largest a row of the
      kernel table); the card's bf16 step against the port's f32 CPU step
      at the same width, weights, 4 rows and draws (TRAIN_TOL: the frozen
      GPT's latent, losses, the global grad norm, per-tensor gradient
      cosines with the trunk's attention and resblock weights named); each
      raw kernel wrapper refusing an input that requires grad; both trained
      models exported (export_release) and served by
      TextToSpeech.from_checkpoints;
  (l) codec GAN training, at default_config() widths (codec 192 channels,
      1024 codes, the full MultiPeriodDiscriminator, 20480-sample slices,
      f32 with TF32 off, the device warp and EQ on) on a seeded dataset of
      32 synthetic voices of 1-4 s at 32 kHz written with save_wav: the
      vqvae trainer for 8 steps of batch 8 with checkpoints at 4 and 8, and
      a resume from 4; every loss finite; per step the quantizer's searches
      and the VQ kernel's launches (2 on the first: the k-means init's
      residual pass, then the search; 1 after), its plain version never
      called and no other kernel; step ms, peak memory and the busy share
      of 3 steady steps; the VQ kernel against its plain version at the
      largest shape the steps gave it (a row of its own in the kernel
      table) beside cuBLAS's x @ cb.T; one step on the card against the f32
      CPU step at the same weights (the trained codebook), 2 rows and draws,
      dropout off (GAN_TOL: codes, losses, G and D grad norms and cosines;
      the card's step under deterministic algorithms, the CPU's fed the
      card's codes; two card steps with the default algorithms beside it,
      their spread logged);
  (m) the rest of the five-stage recipe at default_config() widths, through
      the port's CLIs and trainers: 12 seeded 32 kHz recordings of three
      2-5 s synthetic voices between 0.8 s silences through `pipeline vad`,
      `asr` (a transcribe hook the phase writes), `bpe-corpus`, then `mel`
      and `vq` on the card (vq through phase (l)'s last checkpoint: one VQ
      launch a clip, its plain version never; clip 0's codes equal to the
      f32 CPU path's, its mel within RECIPE_TOL); `train.mains clvp`
      (768 wide, 20 + 20 layers, bf16 autocast) for 8 steps of batch 32
      with a checkpoint at 4 and a resume from it, no kernel launched, step
      time, memory and busy share, the card's step against the f32 CPU step
      (4 rows, dropout off; RECIPE_TOL, shown to refuse the pooling and
      InfoNCE left under bf16 autocast), the export served by
      TextToSpeech.from_checkpoints(clvp=...); `train.mains classifier` for
      8 steps on clean and noise lists of the clips, `misc classify` with its
      export and `pipeline filter-noise`; make_diffusion_eval_fn through a
      diffusion Trainer with eval_freq 1 on phase (k)'s denoiser and frozen
      GPT (50 DPM++(2M) steps: each trunk kernel launched as often as its
      call sites were called, the causal kernel once per GPT layer; each of
      the three against its plain version at every shape the hook gave it,
      the largest a `<kernel>_eval_hook` row of the kernel table; its ms),
      and its 10-step mel and waveform against the f32 CPU hook's with shared
      noise;
  (n) the model library at full width, seeded weights (attention output
      projections non-zero), four seeded 5 s voices: RVQ1 at its defaults
      (spec 1025 of the 32 kHz voices at n_fft 2048, hop 640: 250 frames a
      clip, 500 rows of 1024 codes of D=1024 a search) through one training
      forward on a seeded (4, 250, 1024) distillation target (the k-means
      init, then the search), extract_code, decode of its codes and infer;
      DiscreteVAE at its defaults (512 codes of D=512) on the voices'
      tacotron mel at 22.05 kHz through one training forward,
      get_codebook_indices and decode_codes. Each call's VQ searches equal
      the VQ kernel's launches (2 in a training forward: the k-means
      residual pass, then the search), the plain version never called, no
      other kernel; median ms of each call. The card against the f32 CPU
      path with the trained codebooks: codes equal but for near-ties of the
      CPU's two nearest distances (LIB_TIE, counted), the style, the
      semantic content, clip 0's infer / decode waveforms (shared noise) and
      the DVAE's decoded mel within LIB_TOL. The VQ kernel against its plain
      version at every shape the calls gave it and at D=1024 with N=1 and
      N=41 (phase (c)'s reading), the RVQ1 and DVAE shapes rows of the
      kernel table (vq_nearest_rvq1, vq_nearest_dvae) with the device time
      of kernel, plain version and cuBLAS's x @ cb.T; then one DiffusionTts
      training forward and backward at its defaults with injected draws:
      finite loss and grad norm, no kernel launched;
  (o) multi-GPU (ttts_tpu_torch.parallel) at world size 1 under NCCL (the
      one card; ranks > 1 are held on the CPU by tests/test_torch_dist_*.py
      and test_torch_parallel.py): with cuDNN's and PyTorch's deterministic
      algorithms on, one GPT trainer step and one codec GAN trainer step
      through train.mains at default_config() widths without a process
      group, then `init_process_group("nccl", world_size=1)` (no fallback)
      and the same steps with the mesh of cfg.mesh, through the
      data-parallel all-reduce: losses, parameters, optimizer and codebook
      states bit-equal, VQ launches equal; TextToSpeech(default_config(),
      mesh=make_mesh(MeshConfig(data=1, model=1))).tts_batch of two texts
      bit-equal to the mesh-less call, its launches equal and equal to its
      call sites; the decode kernel on tensor-parallel shards' own caches,
      allocated at (4, 8/tp, 563, 64) for tp = 2 and 4, concatenated equal
      to the full-cache launch exactly and within DECODE_TOL of the plain
      version, timed against its bound (rows decode_attention_tp2 / _tp4,
      whose launches are those counted on the shards' caches), and
      torch.profiler's device time of kernel, plain version and SDPA there;
      the median ms of the NCCL all-reduce of the GPT's gradients;
  (p) the GPT's long-context training route (gpt.flash_attention, attention
      dropout 0: attention.FlashCausal): the forward kernel with its
      log2-sum-exp2 output (csrc/attention_fwd.cu) and the backward kernels
      (csrc/attention_bwd.cu) against their plain versions at T = 1, 63, 64,
      65, 127, 128, 129, 191, 192, 193, 255, 256, 257 at D=64 and D=32 (the
      edges of the 64-row warpgroups, the forward's 128-key tiles and
      192-query blocks, the backward's 128- and 192-row blocks) and at T =
      100, 164 and 1796 at D=64, each limit beside its reading and failed by
      its planted fault in phase (g); the backward from a fresh thread (no current
      CUDA context) equal to this thread's; both timed at the reference
      context (B=64, text
      256 + mel 1536: T=1796, H=8, D=64) beside their bound, plain version
      and SDPA (rows flash_causal_lse, flash_causal_bwd), and forward plus
      backward as one autograd call beside SDPA's; one loss and its
      gradients of default_config()'s GPT through the flash route and the
      SDPA route at that batch (TRAIN_TOL; 6 forward launches and 12
      backward ones: a dQ and a dK/dV kernel a layer); gpt_train_step
      (bf16 autocast, AdamW) timed in turns
      (flash, SDPA, SDPA, flash): step ms, tokens/s, peak memory, busy share,
      launches; the flash step repeated bit for bit under deterministic
      algorithms; `train.mains gpt --config` with flash, attention dropout 0
      and checkpointing for 4 steps at phase (k)'s sizes (12 forward and 12
      backward launches a step: the checkpoint recomputes each block);
  (q) the grouped expert kernel of the MLA-MoE trunk (csrc/moe_experts.cu,
      ops/cuda/moe.moe_experts) at the `serve.moonlight.fast.b16` cell's
      widths (D 2048, F 1408, 64 experts, top 6) and pair counts (a decode
      step's 384, a prefill's 38 400, a latent pass's 27 840) against its
      plain per-expert loop (MOE_TOL), timed beside its bound, that loop, a
      bf16 cuBLAS loop of three products an expert, torch._grouped_mm where
      the installed torch has it, and, at the decode shape, one batched
      product of every expert over every row; then a 3-layer trunk at the
      published widths (a dense layer, two routed) through
      `inference_speech` on 64 rows: the kernel's launches and the moe
      counters of a replayed call against its routed layers' passes, and a
      steady call timed with and without the benchmark's route capture
      (portbench/traffic/serve_batch_lm.RouteCapture).
The last two lines are the kernel table as JSON and then
{"ok": true, "device": {...}}. Imports no JAX; needs a CUDA card.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from functools import partial

import numpy as np
import torch

ATTN_SRC, ATTN_TPU = "ttts_tpu_torch/csrc/attention.cu", "ttts_tpu/ops/pallas/attention.py"
RES_SRC, RES_TPU = "ttts_tpu_torch/csrc/resblock.cu", "ttts_tpu/ops/pallas/resblock.py"
FLASH_TPU = "ttts_tpu/models/gpt.py:283 -> jax/experimental/pallas/ops/tpu/flash_attention.py"
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
    # the GPT's training route: the library kernel behind ttts_tpu/models/
    # gpt.py:283 (_flash_causal_attention), its forward and its backward
    "flash_causal_lse": ("attention", "flash_attention", "causal_lse",
                         "ttts_tpu_torch/csrc/attention_fwd.cu", f"{FLASH_TPU}:758"),
    "flash_causal_bwd": ("attention", "flash_attention", "causal_bwd",
                         "ttts_tpu_torch/csrc/attention_bwd.cu", f"{FLASH_TPU}:1121 and :1456"),
}
# not on the serving path (no model sets AttentionBlock.fused_gn, as in the
# JAX package): it launches in its own step of phase (d)
OFF_PATH = ("gn_qkv",)
# a mode the TPU kernel computes and no caller uses: phase (c) only
NO_CALLER = ("flash_attention_bias_causal",)
# the GPT's flash training route (gpt.flash_attention): phase (p) only
TRAIN_ONLY = ("flash_causal_lse", "flash_causal_bwd")

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
    max|want|: max(|got - want| - 2^-7 |want|) / max|want| (an all-zero
    reference: 0 where got is zero too, else inf)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    scale, worst = float(want.abs().max()), float((err - BF16_STEP * want.abs()).max())
    return {"max_abs": float(err.max()),
            "rel_l2": float((got - want).norm() / want.norm()),
            "excess": worst / scale if scale else (math.inf if worst > 0 else 0.0)}


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


def _vq_inputs(g, n, bins, d: int = 192):
    """x (n, d), codebook (bins, d) with an exact tie: code 7 = code 3 =
    x[0], so both versions must pick index 3 for row 0."""
    cb = torch.randn(bins, d, generator=g, device="cuda")
    cb[7] = cb[3]
    x = torch.randn(n, d, generator=g, device="cuda")
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
    for gen, shape in shapes:
        _hold_bias(rows, gen, shape)
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
    for shape in ((1, 65, 8, 64), (2, 129, 4, 32), (2, 100, 8, 64), (4, 163, 8, 64),
                  (1, 436, 8, 64)):
        _hold_causal(rows, g, shape)


def _hold_bias(rows, gen, shape, name: str = "flash_attention_bias", note: str = "") -> None:
    """The bias kernel against its plain version at `shape` (B, T, H, D), on
    strided q/k/v views of one fused per-head [q; k; v] tensor, as the
    diffusion net passes them, and a random (H, 2T - 1) strip; a row `name`."""
    from ttts_tpu_torch.ops.cuda.attention import flash_attention_plain, toeplitz_bias

    fn, bf, (b, t, h, d) = wrapper("flash_attention_bias"), torch.bfloat16, shape
    qkv = torch.randn(b, t, h, 3 * d, generator=gen, device="cuda").to(bf)
    q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    strip = torch.randn(h, 2 * t - 1, generator=gen, device="cuda")
    got, want = fn(q, k, v, strip), flash_attention_plain(q, k, v, strip)
    torch.cuda.synchronize()
    # library: SDPA with the (H, T, T) bias built beforehand (not timed)
    qt, kt, vt = (z.transpose(1, 2) for z in (q, k, v))
    mask = toeplitz_bias(strip, t).to(bf)[None]
    _timed(rows, name, f"B={b} T={t} H={h} D={d} bf16{note}", compare(got, want), "rel_l2",
           ATTN_TOL, partial(fn, q, k, v, strip), partial(flash_attention_plain, q, k, v, strip),
           partial(torch.nn.functional.scaled_dot_product_attention, qt, kt, vt,
                   attn_mask=mask), _attention_work(b, t, h, d, True, False))


def _hold_causal(rows, gen, shape, name: str = "flash_attention_causal",
                 note: str = "") -> None:
    """The causal kernel against its plain version at `shape` (B, T, H, D),
    as views of the GPT's fused [q; k; v] projection; a row `name`."""
    from ttts_tpu_torch.ops.cuda.attention import flash_attention_plain

    fn, (b, t, h, d) = wrapper("flash_attention_causal"), shape
    qkv = torch.randn(b, t, 3 * h * d, generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].reshape(b, t, h, d) for i in range(3))
    got, want = fn(q, k, v, causal=True), flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    qt, kt, vt = (z.transpose(1, 2) for z in (q, k, v))
    _timed(rows, name, f"B={b} T={t} H={h} D={d} bf16{note}", compare(got, want), "rel_l2",
           ATTN_TOL, partial(fn, q, k, v, causal=True),
           partial(flash_attention_plain, q, k, v, causal=True),
           partial(torch.nn.functional.scaled_dot_product_attention, qt, kt, vt,
                   is_causal=True), _attention_work(b, t, h, d, False, True))


def _resblock_args(g, b, t, c):
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    return ((rn(b, t, c)).to(torch.bfloat16), 1 + 0.1 * rn(c), 0.1 * rn(c),
            (rn(c, c) / math.sqrt(c)).to(torch.bfloat16), 0.1 * rn(c),
            1 + 0.1 * rn(b, c), 0.1 * rn(b, c),
            (rn(3, c, c) / math.sqrt(3 * c)).to(torch.bfloat16), 0.1 * rn(c))


def _check_resblock(g, rows):
    # T=96: one ragged 128-row tile; B=1 T=1600 (a ragged last tile of 64
    # rows, no neighbouring batch); T=1632 (51 code buckets of 32, a last
    # tile of 96 rows); then the path's buckets, T=1600 the longest
    edge = _edge_generator()
    for gen, (b, t) in ((edge, (2, 96)), (edge, (1, 1600)), (edge, (2, 1632)), (g, (2, 1024)),
                        (g, (2, 1600))):
        _hold_resblock(rows, gen, (b, t, 512))


def _hold_resblock(rows, gen, shape, name: str = "scale_shift_resblock",
                   note: str = "") -> None:
    """The resblock kernel against its plain version at x's `shape` (B, T,
    C); a row `name`."""
    from ttts_tpu_torch.ops.cuda.resblock import fused_scale_shift_resblock_plain

    fn, (b, t, c) = wrapper("scale_shift_resblock"), shape
    args = _resblock_args(gen, b, t, c)
    got, want = fn(*args), fused_scale_shift_resblock_plain(*args)
    torch.cuda.synchronize()
    _timed(rows, name, f"B={b} T={t} C={c} bf16{note}", compare(got, want), "excess", RES_TOL,
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


def make_tts(device: str, cfg=None, mesh=None):
    """TextToSpeech(cfg or default_config(), mesh=mesh) on seeded random
    weights, with the diffusion net's attention output projections made
    non-zero."""
    from ttts_tpu_torch.api import TextToSpeech

    tts = TextToSpeech(cfg, device=device, seed=0, mesh=mesh)
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
    causal attention; a block called while a CUDA graph captures launches
    nothing, so it counts into the captured decode's own tally, which each
    of its replays adds: the watched models' captured decodes are dropped on
    entry and on undo, so every capture is seen), CLVP's unmasked x-transformers
    attentions without active dropout, the
    diffusion AttentionBlocks (bias, or no bias without relative position
    embeddings; gn_qkv with fused_gn) and ScaleShiftResBlocks, and a wrapper
    around models.quantize.nearest. Returns (counts by kernel, undo)."""
    from ttts_tpu_torch.models import clvp, diffusion_net, gpt, quantize

    sites = dict.fromkeys(KERNELS, 0)
    captured = dict.fromkeys(KERNELS, 0)  # the call sites of the capture under way
    graphs = gpt._DecodeGraphs

    class WatchedGraphs(graphs):
        def __init__(self, *args):
            captured.update(dict.fromkeys(KERNELS, 0))
            super().__init__(*args)
            self.sites = dict(captured)  # a replay's call sites

        def replay_decode(self):
            super().replay_decode()
            for name, n in self.sites.items():
                sites[name] += n

    def drop_captures():
        for model in models:
            if isinstance(model, gpt.UnifiedVoice):
                model.decode_graph = None

    drop_captures()
    gpt._DecodeGraphs = WatchedGraphs

    def gpt_block(mod, args, kwargs):
        cache = args[1] if len(args) > 1 else kwargs.get("cache")
        one_row = cache is not None and args[0].shape[1] == 1
        tally = captured if torch.cuda.is_current_stream_capturing() else sites
        tally["decode_attention" if one_row else "flash_attention_causal"] += 1

    def clvp_attention(mod, args, kwargs):  # Attention.forward's dispatch rule
        mask = args[1] if len(args) > 1 else kwargs.get("mask")
        if mask is None and not (mod.training and mod.dropout):
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
        gpt._DecodeGraphs = graphs
        drop_captures()

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
               if c == 0 and n not in OFF_PATH + NO_CALLER + TRAIN_ONLY]
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
# kernel, ties resolved to the higher index (the key's index bits inverted);
# in the flash route's forward (attention_fwd.cu), the second consumer
# warpgroup's diagonal mask one key late (T=164: rows 64-127 of the first
# 192-query block, whose diagonal tile starts 64 keys before them). Copy 1:
# the FiLM scale a2 dropped, which every resblock call meets; the mean
# dropped from gn_qkv's multiply-add; rank 7's codes dropped from the VQ
# cluster merge; log2(l) left out of the flash forward's lse2 and, in the
# flash backward's dK/dV kernel, the second consumer warpgroup's rows
# dropped from the store (T=164: key block 0 fills both warpgroups; the
# backward's plain version is fed the same lse2). Copy 2: ||e||^2 dropped
# from the VQ distance (each VQ fault meets every VQ call, so each has its
# own copy); the flash forward's third consumer warpgroup's rows dropped
# (zeroed) from O (T=164: rows 128-163, whose diagonal tile is the ragged
# one); in the flash backward, the dK/dV kernel's causal mask dropped (its
# diagonal tiles) and dQ's 1/sqrt(D) dropped, read on dk / dv and on dq.
# Each VQ fault is read at the codec's D=192 and at phase (n)'s RVQ1
# (D=1024) and DVAE (D=512) shapes, but rank 7's, which 512 codes never
# reach (they fill ranks 0-3 of the 8 slices of 128).
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
    (0, "attention_fwd.cu", "if (col > row + diag) s[x] = -INFINITY;",
     "if (col > row + diag + (w == 1)) s[x] = -INFINITY;"),
    (1, "attention_fwd.cu", "m[r] * c + log2f(l[r])", "m[r] * c"),
    (2, "attention_fwd.cu", "const float inv = 1.f / l[r];",
     "const float inv = w == 2 ? 0.f : 1.f / l[r];"),
    (2, "attention_bwd.cu", "keep = q0 + j >= kw0 + i && q0 + j < T;", "keep = q0 + j < T;"),
    (2, "attention_bwd.cu",
     "pack_bf16(acc[4 * n + 2 * r] * scale, acc[4 * n + 2 * r + 1] * scale)",
     "pack_bf16(acc[4 * n + 2 * r], acc[4 * n + 2 * r + 1])"),
    (1, "attention_bwd.cu", "const int t = kw0 + row0 + r * 8;",
     "const int t = w ? T : kw0 + row0 + r * 8;"),
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

    def vq(n=500, bins=1024, d=192):
        x, cb = _vq_inputs(g, n, bins, d)
        return _vq_reading(x, cb, wrapper("vq_nearest")(x, cb))

    def vq_shapes(fault: str, dvae: bool = True) -> list:
        """The fault read at the codec's shape, RVQ1's (phase (n)) and, with
        `dvae`, the DVAE's."""
        shapes = ((500, 1024, 192), (500, 1024, 1024)) + (((212, 512, 512),) if dvae else ())
        return [(f"{fault}, N={n} bins={bins} D={d}", "wrong", 0, vq(n, bins, d))
                for n, bins, d in shapes]

    flash = "B=2 T=164 H=8 D=64 (a ragged diagonal tile)"
    if copy == 2:
        m = _flash_readings((2, 164, 8, 64), g)
        return vq_shapes("||e||^2 dropped from the VQ distance") + [
            (f"the flash forward's third consumer warpgroup's rows dropped from O, {flash}",
             "rel_l2", ATTN_TOL, m["o"]),
            (f"dK/dV's diagonal-tile causal mask dropped, dk, {flash}", "rel_l2", BWD_TOL,
             m["dk"]),
            (f"dK/dV's diagonal-tile causal mask dropped, dv, {flash}", "rel_l2", BWD_TOL,
             m["dv"]),
            (f"dQ's 1/sqrt(D) dropped, dq, {flash}", "rel_l2", BWD_TOL, m["dq"])]
    if copy == 1:  # the backward is fed the same O and lse2 as its plain version
        m = _flash_readings((2, 164, 8, 64), g)
        return [(f"log2(l) left out of the flash forward's lse2, {flash}", "max_abs", LSE_TOL,
                 m["lse"]),
                (f"dK/dV's second consumer warpgroup's rows dropped from the store, dk, {flash}",
                 "rel_l2", BWD_TOL, m["dk"]),
                (f"dK/dV's second consumer warpgroup's rows dropped from the store, dv, {flash}",
                 "rel_l2", BWD_TOL, m["dv"]),
                ("FiLM scale a2 dropped, resblock B=2 T=1600 C=512", "excess", RES_TOL,
                 resblock(2, 1600)),
                ("GN mean dropped from the multiply-add, gn_qkv B=2 T=1024 C=512", "excess",
                 RES_TOL, gn_qkv())] + vq_shapes(
                     # 512 codes fill ranks 0-3 of a cluster's 8 slices of 128
                     "rank 7's codes dropped from the VQ cluster merge", dvae=False)
    (q, k, v), (q2, k2, v2), (q3, k3, v3) = (
        torch.randn(b, t, 3, h, d, generator=g, device="cuda").to(bf).unbind(2)
        for b, t, h, d in ((4, 192, 8, 64), (4, 32, 16, 64), (2, 128, 16, 32)))
    strip = torch.randn(16, 2 * 128 - 1, generator=g, device="cuda")
    dec = [torch.randn(*s, generator=g, device="cuda").to(bf)
           for s in [(4, 8, 64)] * 3 + [(4, 8, 563, 64)] * 2]
    ref = [x.float() for x in dec]  # the plain version on f32 copies, as phase (c)
    m = _flash_readings((2, 164, 8, 64), g)
    return [
        (f"the flash forward's second consumer warpgroup's diagonal mask one key late, "
         f"{flash}", "rel_l2", ATTN_TOL, m["o"]),
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
    ] + vq_shapes("VQ ties to the higher index")


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
    caught fewer than `reps` device events lost some and is taken again;
    after three such sessions the CUDA events' time stands in."""
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
        return ("not measured by the profiler (too few device events in 3 sessions); CUDA "
                f"events {median_ms(fn, reps=reps) * 1e3:.1f} us per call, host work included")
    total = sum(us for _, us in by_kernel.values()) / reps
    parts = ", ".join(f"{name[:28]} {us / reps:.1f} us x{n / reps:g}"
                      for name, (n, us) in by_kernel.items())
    again = f", session {attempt}" if attempt > 1 else ""
    return f"{total:.1f} us ({parts}{again})"


def device_total_us(reading: str):
    """The total us of a device_us reading of a call whose every kernel
    launches at least once, or None where the profiler measured none or
    dropped events (a kernel read below one launch a call)."""
    head = reading.split(" ", 1)[0]
    counts = [float(x) for x in re.findall(r" x([0-9.]+)[,)]", reading)]
    if not head.replace(".", "", 1).isdigit() or any(n < 1 for n in counts):
        return None
    return float(head)


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
        if name in TRAIN_ONLY:  # phase (p) times them at the GPT's training shapes
            continue
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


def _run_trainer(make, what: str, tokens, tag: str = "(k)") -> dict:
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
    for h in hist:  # a step without a grad norm (the classifier's) reads 0 there
        loss, norm = float(h["loss"]), float(h.get("grad_norm", 0.0))
        if (not (math.isfinite(loss) and math.isfinite(norm))
                or h.get("nonfinite_skipped", 0.0)):
            raise RuntimeError(f"{tag} {what}: step {h['step']} loss {loss} grad norm {norm}")
    steady = hist[3:] if len(hist) > 3 else hist
    secs = [h["seconds"] for h in steady]
    ms, spread = float(np.median(secs)) * 1e3, (min(secs) * 1e3, max(secs) * 1e3)
    per_s = sum(work[len(hist) - len(steady):]) / sum(secs)
    norms = [float(h["grad_norm"]) for h in hist if "grad_norm" in h]
    norms = f", grad norms {min(norms):.3f}-{max(norms):.3f}" if norms else ""
    log(f"{tag} {what}: steps {start + 1}-{trainer.step}, loss "
        f"{float(hist[0]['loss']):.4f} -> {float(hist[-1]['loss']):.4f}{norms}, all finite | "
        f"{len(steady)} steady "
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


def _hold_train(what: str, loss_card, loss_cpu, reading, named, tol=TRAIN_TOL,
                tag: str = "(k)", against: str = "card vs f32 CPU") -> None:
    lrel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    nrel = abs(reading["norm_card"] - reading["norm_cpu"]) / reading["norm_cpu"]
    cos = reading["cos"]
    worst = min(cos, key=cos.get)
    named_cos = {n: cos[n] for n in named if n in cos}
    log(f"{tag} {what}, {against}: loss {loss_card:.6f} vs {loss_cpu:.6f}, rel "
        f"{lrel:.3e} (tol {tol['loss_rel']}) | grad norm {reading['norm_card']:.5f} vs "
        f"{reading['norm_cpu']:.5f}, rel {nrel:.3e} (tol {tol['grad_norm_rel']}) | "
        f"least cosine of {len(cos)} tensors {cos[worst]:.5f} ({worst}; tol "
        f"{tol['min_cos']}) | cut gradients {reading['cut'] or 'none'} | zero "
        f"analytically (below {NOISE} of the norm): {reading['noise'] or 'none'}")
    for n, c in named_cos.items():
        log(f"{tag}   cosine {c:.5f} {n} (tol {tol['named_cos']})")
    bad = (reading["cut"] or lrel > tol["loss_rel"] or nrel > tol["grad_norm_rel"]
           or cos[worst] < tol["min_cos"] or len(named_cos) != len(named)
           or any(c < tol["named_cos"] for c in named_cos.values()))
    if bad:
        raise RuntimeError(f"{tag} {what}: the card's step disagrees with the CPU's")


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


class _PathShapes:
    """Within the block, the shapes of every causal, bias-attention and
    resblock kernel launch, by kernel name: spies in place of
    attention.flash_attention and resblock.fused_scale_shift_resblock, which
    the dispatches look up at each call (the launch counts they keep are the
    wrappers' own)."""

    def __enter__(self):
        from ttts_tpu_torch.ops.cuda import attention, resblock

        self.shapes = {n: set() for n in HELD}
        self.attn, self.res = attention, resblock
        attend, fused = self.fns = attention.flash_attention, resblock.fused_scale_shift_resblock

        def attn_spy(q, k, v, strip=None, causal=False):
            if causal != (strip is not None):
                self.shapes["flash_attention_causal" if causal else
                            "flash_attention_bias"].add(tuple(q.shape))
            return attend(q, k, v, strip, causal)

        def res_spy(x, *args, **kwargs):
            self.shapes["scale_shift_resblock"].add(tuple(x.shape))
            return fused(x, *args, **kwargs)

        attn_spy.launches = attend.launches  # a dict: the same object
        res_spy.launches = fused.launches  # an int: the wrapper adds to the spy's
        attention.flash_attention, resblock.fused_scale_shift_resblock = attn_spy, res_spy
        return self

    def __exit__(self, *exc):
        attend, fused = self.fns
        fused.launches = self.res.fused_scale_shift_resblock.launches
        self.attn.flash_attention, self.res.fused_scale_shift_resblock = attend, fused


# the kernels a _PathShapes records, and how each is held at a shape
HELD = {"flash_attention_bias": _hold_bias, "flash_attention_causal": _hold_causal,
        "scale_shift_resblock": _hold_resblock}


def _hold_path_shapes(rows, shapes, tag: str, what: str, suffix: str = "") -> None:
    """Each kernel a _PathShapes saw launch against its plain version at
    every shape `what` gave it, at its phase-(c) tolerance, the largest last
    (its row, `name + suffix`, is the kernel table's), with torch.profiler
    device time at the largest."""
    g = torch.Generator("cuda").manual_seed(12)
    for name, seen in shapes.items():
        for shape in sorted(seen, key=lambda s: (math.prod(s[:2]), s)):
            HELD[name](rows, g, shape, name + suffix, f" ({what})")
        if seen:
            row = rows[-1]
            lib = device_us(row["run_library"]) if row["run_library"] else "none"
            log(f"{tag} {name} shapes of the {what}: {sorted(seen)} | device time at "
                f"{row['shape']} (torch.profiler): kernel {device_us(row['run'])} | plain "
                f"{device_us(row['run_plain'])} | library {lib}")


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
        "flash_causal_forward": lambda: attention.flash_causal_forward(
            q.clone().requires_grad_(), q, q),
        "flash_causal_backward": lambda: attention.flash_causal_backward(
            q, q, q, q, torch.zeros(1, 2, 64, device="cuda"), q.clone().requires_grad_()),
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
        with _PathShapes() as seen:
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
        _hold_path_shapes(rows, seen.shapes, "(k)", "diffusion train step")
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
        return per_step, {"gpt": {k: v.cpu() for k, v in gpt_sd.items()},
                          "diffusion": {k: v.cpu() for k, v in net_sd.items()}}
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------- (l)

# Card (f32, TF32 off) against the port's f32 CPU step at the same full
# width, weights (the trained codec with its codebook initialised), 2 rows
# and injected draws, dropout off: the codes' agreement, each loss's
# relative error, and for G and D the global grad norm's relative error and
# the least per-tensor cosine (tensors below NOISE of the global norm are
# listed, not held). Three runs on an H100 80GB HBM3 at 700 W (PERF.md)
# read: codes 40 of 40 equal; losses <= 8.2e-5 (the commit loss; the others
# <= 2.2e-6); grad norms G <= 6.6e-7, D <= 3.4e-6; least cosine G 0.99994,
# D 1.00000. The limits are a few times those; one code may split a
# near-tie (the kernel and the plain version order their sums apart).
# One run read G's grad norm 2.04e-5 from the CPU's. The card against
# itself with the default algorithms reads 3.6e-9 to 3.5e-8 (three runs),
# so cuDNN's choice of algorithm does not explain it; every run's searches
# hold a row whose two nearest codes differ by 2.9e-5 of the distance, and
# a code split there (which codes_agree allows) changes the commit loss's
# gradient. So the held step runs under deterministic algorithms and the
# CPU step quantizes with the card's codes: G 6.2e-8 to 1.3e-7, D 2.3e-7
# to 4.3e-6 over three runs, the limits unchanged.
GAN_TOL = {"codes_agree": 39 / 40, "loss_rel": 5e-4, "grad_norm_rel": 2e-5, "min_cos": 0.9998}
GAN_STEPS, GAN_SAVE, GAN_BATCH = 8, 4, 8
GAN_TEXTS = (TEXT, TEXT2, "ta1 shuo1 ming2 tian1 hui4 xia4 yu3")


def _gan_data(root, rows: int = 32, seed: int = 5) -> str:
    """A seeded manifest of `rows` synthetic voices of 1-4 s at 32 kHz
    (written with the port's save_wav) and pinyin texts."""
    from ttts_tpu_torch.data.audio import save_wav
    from ttts_tpu_torch.data.manifest import write_manifest

    rng = np.random.default_rng(seed)
    table = []
    for i in range(rows):
        path = str(root / f"voice{i:03d}.wav")
        save_wav(path, synthetic_voice(float(rng.uniform(1.0, 4.0)), 32000, seed + i), 32000)
        table.append({"text": GAN_TEXTS[i % len(GAN_TEXTS)], "path": path})
    write_manifest(root / "wavs.jsonl", table)
    return str(root / "wavs.jsonl")


class _VqSpy:
    """Within the block: the calls of the VQ search dispatch (vq.nearest),
    their (N, bins, D) shapes and the last call's inputs, and the calls of
    its plain version (spies on the module's names, which the dispatch
    looks up at each call)."""

    def __enter__(self):
        from ttts_tpu_torch.ops.cuda import vq

        self.vq, self.calls, self.plain, self.shapes, self.last = vq, 0, 0, set(), None
        self.real = (vq.nearest, vq.vq_nearest_plain)
        nearest, plain = self.real

        def spy_nearest(x, cb):
            self.calls += 1
            self.shapes.add((x.shape[0], cb.shape[0], x.shape[1]))
            self.last = (x, cb)
            return nearest(x, cb)

        def spy_plain(x, cb):
            self.plain += 1
            return plain(x, cb)

        vq.nearest, vq.vq_nearest_plain = spy_nearest, spy_plain
        return self

    def __exit__(self, *exc):
        self.vq.nearest, self.vq.vq_nearest_plain = self.real


class _VqWatch(_VqSpy):
    """_VqSpy within the block, and per step of `trainer` (a wrapper of its
    step) the searches, the kernel's launches (its wrapper's count) and the
    plain version's calls."""

    def __init__(self, trainer):
        self.trainer, self.per_step = trainer, []

    def __enter__(self):
        super().__enter__()
        step_fn = self.trainer.step_fn

        def counted(state, batch, key):
            before = (self.calls, self.vq.vq_nearest.launches, self.plain)
            out = step_fn(state, batch, key)
            self.per_step.append((self.calls - before[0],
                                  self.vq.vq_nearest.launches - before[1],
                                  self.plain - before[2]))
            return out

        self.trainer.step_fn = counted
        return self


def _run_gan(make, what: str) -> dict:
    """Train the GAN trainer `make()` builds to its end on the card, each
    step ending in a synchronise; → its trainer, launches, per-step VQ
    readings, median step ms over the steps after the first and peak
    memory."""
    trainer = make()
    start = trainer.step
    step_fn = trainer.step_fn

    def synced(state, batch, key):
        metrics = step_fn(state, batch, key)
        torch.cuda.synchronize()
        return metrics

    trainer.step_fn = synced
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with _VqWatch(trainer) as watch:
        trainer.train()
    launches = counts()
    hist = list(trainer.history)
    for h in hist:
        bad = [k for k, v in h.items() if k not in ("step", "seconds")
               and not math.isfinite(float(v))]
        if bad:
            raise RuntimeError(f"(l) {what}: step {h['step']} non-finite {bad}")
    steady = hist[1:] if len(hist) > 1 else hist
    secs = [h["seconds"] for h in steady]
    ms, spread = float(np.median(secs)) * 1e3, (min(secs) * 1e3, max(secs) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"(l) {what}: steps {start + 1}-{trainer.step}, loss_gen_all "
        f"{float(hist[0]['loss_gen_all']):.3f} -> {float(hist[-1]['loss_gen_all']):.3f}, "
        f"loss_disc {float(hist[0]['loss_disc']):.3f} -> {float(hist[-1]['loss_disc']):.3f}, "
        f"all finite | first step {hist[0]['seconds'] * 1e3:.1f} ms, {len(steady)} later "
        f"steps: median {ms:.1f} ms ({spread[0]:.1f}-{spread[1]:.1f}) | peak memory "
        f"{peak:.2f} GiB | per step (searches, VQ launches, plain calls): {watch.per_step}")
    return {"trainer": trainer, "launches": launches, "per_step": watch.per_step,
            "shapes": watch.shapes, "ms": ms, "spread": spread, "steps": len(hist),
            "peak": peak}


def _to(tree, device):
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree


def _compare_gan(cfg, g_sd, d_sd, batch) -> None:
    """One GAN step, EQ and device warp on, on the card and the CPU (f32
    both) at the same weights, codebook and draws, dropout off (the two
    devices' generators draw other masks); the gradients each optimizer
    receives are recorded. The card's step runs twice with the default
    algorithms (their spread is logged: the card against itself), then once
    under deterministic algorithms, the step held against the CPU's. The
    CPU step quantizes with the card's codes (its own are held to
    codes_agree), so that a code split at a near-tie does not move the
    compared losses and gradients."""
    from ttts_tpu_torch.models.discriminator import MultiPeriodDiscriminator
    from ttts_tpu_torch.models.vqvae import SynthesizerTrn
    from ttts_tpu_torch.ops.cuda import vq
    from ttts_tpu_torch.train import mains
    from ttts_tpu_torch.train.state import GanState, TrainState, make_gan_adam
    from ttts_tpu_torch.train.steps import vqvae_draws, vqvae_train_step

    a, t = cfg.audio, cfg.train
    aug = mains.make_vqvae_augment_cfg(cfg)
    seg = t.segment_size // a.hop_length
    draws = None

    def step(dev, feed=None):
        """(metrics, grads, codes, VQ launches, G and D parameter names, the
        searches' (x, codebook)) of one step on `dev`; `feed`: the codes each
        VQ search returns."""
        nonlocal draws
        gen = SynthesizerTrn(cfg.vqvae, a.filter_length // 2 + 1, seg, for_training=True)
        gen.load_state_dict(g_sd)
        for m in gen.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
        disc = MultiPeriodDiscriminator()
        disc.load_state_dict(d_sd)
        opt = lambda ps: make_gan_adam(ps, t.lr, decay=t.lr_decay)  # noqa: E731
        state = GanState(TrainState.create(gen.to(dev), opt), TrainState.create(disc.to(dev), opt))
        grads = {}
        for side in ("g", "d"):
            st = getattr(state, side)

            def update(gs, norm=None, _side=side, _update=st.opt.update):
                grads[_side] = [None if x is None else x.detach().double().cpu() for x in gs]
                return _update(gs, norm)

            st.opt.update = update
        b = {k: v.to(dev) for k, v in batch.items()}
        if draws is None:
            draws = vqvae_draws(7, {k: v.cpu() for k, v in b.items()}, gen, a.hop_length, aug,
                                device_warp=True)
        codes, searched = [], []
        real = vq.nearest

        def kept(x, cb):
            searched.append((x.detach().double().cpu(), cb.detach().double().cpu()))
            codes.append(real(x, cb))
            return codes[-1] if feed is None else feed[len(codes) - 1].to(codes[-1])

        vq.nearest = kept
        try:
            reset_counts()
            metrics = vqvae_train_step(state, b, 7, a, t.c_mel, t.c_kl, aug, True,
                                       draws=_to(draws, dev))
            launched = count("vq_nearest")
        finally:
            vq.nearest = real
        return (metrics, grads, [c.cpu().long() for c in codes], launched,
                [n for n, _ in gen.named_parameters()], [n for n, _ in disc.named_parameters()],
                searched)

    def norm_rel(x, y, side):
        r = _grad_reading(x[4] if side == "g" else x[5], x[1][side], y[1][side])
        return abs(r["norm_card"] - r["norm_cpu"]) / r["norm_cpu"], min(r["cos"].values())

    default = [step("cuda") for _ in range(2)]
    det = (torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        held = step("cuda")
    finally:
        torch.backends.cudnn.deterministic = det[0]
        torch.use_deterministic_algorithms(det[1])
    spread = {side: norm_rel(default[0], default[1], side) for side in ("g", "d")}
    same_codes = all(torch.equal(x, y) for x, y in zip(default[0][2], held[2]))
    log("(l) GAN step on the card with the default algorithms, twice: G grad norm rel "
        f"{spread['g'][0]:.3e}, least cosine {spread['g'][1]:.6f}; D grad norm rel "
        f"{spread['d'][0]:.3e}, least cosine {spread['d'][1]:.6f} (the card against itself; "
        f"not held) | codes of the default and deterministic steps equal {same_codes}")
    mc, gc, codes_card, lc, gnames, dnames, _ = held
    mp, gp, codes_cpu, lp, _, _, searched = step("cpu", feed=codes_card)
    cc, cp = torch.cat(codes_card), torch.cat(codes_cpu)
    agree = float((cc == cp).float().mean())
    # how near the CPU's searches came to a split: the least gap between a
    # row's nearest distance and the next larger one (f64; equal distances
    # are duplicate codes, which both sides resolve to the first index),
    # relative to the nearest
    ties = []
    for x, cb in searched:
        d = (cb.square().sum(1)[None] - 2 * x.reshape(-1, cb.shape[1]) @ cb.T).sort(1).values
        nxt = torch.where(d > d[:, :1], d, math.inf).min(1).values
        ties.append(float(((nxt - d[:, 0]) / d[:, 0].abs().clamp_min(1e-30)).min()))
    rels = {k: abs(float(mc[k]) - float(mp[k])) / max(abs(float(mp[k])), 1e-12) for k in mp}
    readings = {side: _grad_reading(names, gc[side], gp[side])
                for side, names in (("g", gnames), ("d", dnames))}
    log(f"(l) GAN step, card (deterministic algorithms) vs f32 CPU fed the card's codes "
        f"({batch['wav'].shape[0]} rows of {batch['wav'].shape[1] // a.hop_length} frames, EQ + "
        f"device warp, codebook inited): the CPU's own codes agree {agree:.4f} of {cc.numel()} "
        f"(tol >= {GAN_TOL['codes_agree']}; VQ launches {lc} on the card, {lp} on the CPU; "
        f"least relative gap between a row's two nearest codes {min(ties):.2e}) | "
        "loss rel errors " + ", ".join(f"{k} {v:.2e}" for k, v in rels.items())
        + f" (tol {GAN_TOL['loss_rel']})")
    bad = agree < GAN_TOL["codes_agree"] or lc != 1 or lp != 0 or any(
        v > GAN_TOL["loss_rel"] for v in rels.values())
    for side, r in readings.items():
        nrel = abs(r["norm_card"] - r["norm_cpu"]) / r["norm_cpu"]
        worst = min(r["cos"], key=r["cos"].get)
        log(f"(l)   {side.upper()} grads: global norm {r['norm_card']:.5f} vs "
            f"{r['norm_cpu']:.5f}, "
            f"rel {nrel:.3e} (tol {GAN_TOL['grad_norm_rel']}) | least cosine of "
            f"{len(r['cos'])} tensors {r['cos'][worst]:.6f} ({worst}; tol {GAN_TOL['min_cos']}) "
            f"| cut {r['cut'] or 'none'} | below {NOISE} of the norm, not held: "
            f"{len(r['noise'])} tensors")
        bad = bad or bool(r["cut"]) or nrel > GAN_TOL["grad_norm_rel"] or (
            r["cos"][worst] < GAN_TOL["min_cos"])
    if bad:
        raise RuntimeError("(l) the card's GAN step disagrees with the CPU's")


def _check_gan_vq(rows, shapes, card: str) -> None:
    """The VQ kernel against its plain version at the largest shape the GAN
    step gave it (N = B * T/2 rows x 1024 codes x 192), read as phase (c)
    reads VQ, timed beside cuBLAS's x @ cb.T alone (a floor, not the same
    function)."""
    from ttts_tpu_torch.ops.cuda.vq import vq_nearest_plain

    n, bins, d = max(shapes)
    fn = wrapper("vq_nearest")
    g = torch.Generator("cuda").manual_seed(13)
    x, cb = _vq_inputs(g, n, bins, d)
    m = _vq_reading(x, cb, fn(x, cb))
    torch.cuda.synchronize()
    log(f"(l) VQ kernel shapes of the GAN steps (N, bins, D): {sorted(shapes)}")
    _timed(rows, "vq_nearest_gan_train",
           f"N={n} bins={bins} D={d} f32 (GAN train step): mismatches {m['mism']} (near-ties "
           f"{m['near']}; tolerance: a mismatch only on a <=1e-5 relative distance tie, the exact "
           "tie to index 3), distance gap", m, "wrong", 0,
           partial(fn, x, cb), partial(vq_nearest_plain, x, cb), None,
           (2 * n * bins * d, (n * d + bins * d + n) * 4, PEAK_F32))
    row = rows[-1]
    log(f"(l) device time at that shape (torch.profiler): kernel {device_us(row['run'])} | "
        f"plain {device_us(row['run_plain'])} | floor, x @ cb.T alone (cuBLAS f32, TF32 off) "
        f"{device_us(lambda: x @ cb.T)} | card {card}")


def _gan_augment_share(cfg, trainer, batch, step_launches: float, card: str) -> None:
    """The device warp's and the EQ's part of a steady GAN step: device ms
    and launches of each on the step's batch, with the step's draws."""
    from ttts_tpu_torch.data.augment import apply_peq, warp_batch_device
    from ttts_tpu_torch.train import mains
    from ttts_tpu_torch.train.steps import vqvae_draws

    aug = mains.make_vqvae_augment_cfg(cfg)
    b = trainer._put(batch)
    gen = trainer.state.g.model
    d = vqvae_draws(2, b, gen, cfg.audio.hop_length, aug, True)
    wav = b["wav"][..., 0]
    parts = {"device warp": lambda: warp_batch_device(wav, d["warp"], aug),
             "EQ": lambda: apply_peq(wav, d["peq"]["quality_power"], d["peq"]["gain"], aug)}
    for fn in parts.values():
        fn()  # warm up
    readings = []
    for name, fn in parts.items():
        ms, n, _ = _device_busy(fn)
        readings.append(f"{name} {ms:.2f} ms busy in {n} launches "
                        f"({n / step_launches:.3f} of the step's)")
    log(f"(l) augmentation of one step's batch of {wav.shape[0]}: {'; '.join(readings)} "
        f"(torch.profiler) | card {card}")


def phase_gan(card: str, rows: list, keep=None) -> dict:
    """(l) Codec GAN training at default_config() widths on the card:
    GAN_STEPS steps of batch GAN_BATCH with checkpoints every GAN_SAVE and a
    resume, the VQ kernel launched by every step (2 on the first: the
    k-means init's residual pass, then the search; 1 after) and its plain
    version never; step time, memory, busy share; the VQ kernel at the
    step's largest shape (a row of the kernel table); the card's step
    against the f32 CPU step. `keep`: a directory that receives the last
    checkpoint (in keep/ckpt), which phase (m)'s `pipeline vq` reads."""
    import pathlib
    import shutil
    import tempfile

    from ttts_tpu_torch.config import default_config
    from ttts_tpu_torch.data.datasets import VQGANDataset
    from ttts_tpu_torch.train import mains

    t_phase = time.perf_counter()
    base = default_config()
    cfg = dataclasses.replace(base, train=dataclasses.replace(
        base.train, train_steps=GAN_STEPS, save_freq=GAN_SAVE, batch_size=GAN_BATCH))
    root = pathlib.Path(tempfile.mkdtemp(prefix="ttts_gan_"))
    try:
        manifest = _gan_data(root)
        first = _run_gan(lambda: mains.vqvae_trainer(cfg, manifest, str(root / "gan"), "cuda"),
                         "codec GAN training")
        ckpts = first["trainer"].ckpt.all_steps()
        if ckpts[-2:] != [GAN_SAVE, GAN_STEPS]:
            raise RuntimeError(f"(l) GAN checkpoints {ckpts}")
        shutil.copytree(root / "gan", root / "gan_resume")
        (root / "gan_resume" / "ckpt" / f"step_{GAN_STEPS:08d}.pt").unlink()
        again = _run_gan(lambda: mains.vqvae_trainer(cfg, manifest, str(root / "gan_resume"),
                                                     "cuda"),
                         f"codec GAN resumed from step {GAN_SAVE}")
        if again["steps"] != GAN_STEPS - GAN_SAVE or again["trainer"].step != GAN_STEPS:
            raise RuntimeError("(l) the GAN resume did not continue from its checkpoint")
        want = [(2, 2, 0)] + [(1, 1, 0)] * (GAN_STEPS - 1)
        if first["per_step"] != want or again["per_step"] != want[GAN_SAVE:]:
            raise RuntimeError(f"(l) VQ per step {first['per_step']} / {again['per_step']}, "
                               f"expected {want}")
        others = {n: c for n, c in first["launches"].items() if n != "vq_nearest" and c}
        if others or first["launches"]["vq_nearest"] != GAN_STEPS + 1:
            raise RuntimeError(f"(l) GAN training launched {first['launches']}")
        log(f"(l) VQ launches: {GAN_STEPS + 1} over {GAN_STEPS} steps (2 on step 1, then 1), "
            f"plain version 0 times, no other kernel (as expected) | card {card}")
        _check_gan_vq(rows, first["shapes"] | again["shapes"], card)
        ds = VQGANDataset(manifest)
        batch = ds.collate([ds[i] for i in range(GAN_BATCH)])
        tr = again["trainer"]
        wall, busy, n = _training_busy(tr, batch)
        log(f"(l) 3 steady GAN steps of batch {GAN_BATCH} ({batch['wav'].shape[1] / 32000:.2f} s "
            f"padded clips): wall {wall:.1f} ms without the profiler, device busy {busy:.1f} ms "
            f"in {n} launches under it: busy share {busy / wall:.3f}")
        _gan_augment_share(cfg, tr, batch, n / 3, card)
        pair = ds.collate([ds[0], ds[1]])
        pair = {k: torch.as_tensor(v).long() if v.dtype.kind in "iu" else torch.as_tensor(v)
                for k, v in pair.items()}
        frames = 40  # 0.8 s at hop 640: the CPU's share of the phase stays small
        pair["wav"] = pair["wav"][:, :frames * cfg.audio.hop_length]
        pair["spec_lengths"] = pair["spec_lengths"].clamp(max=frames)
        g_sd = {k: v.cpu() for k, v in tr.state.g.model.state_dict().items()}
        d_sd = {k: v.cpu() for k, v in tr.state.d.model.state_dict().items()}
        _compare_gan(cfg, g_sd, d_sd, pair)
        if keep is not None:
            (keep / "ckpt").mkdir(parents=True, exist_ok=True)
            last = tr.ckpt.path(tr.ckpt.latest_step())
            shutil.copy2(last, keep / "ckpt" / last.name)
        log(f"(l) phase (l) {time.perf_counter() - t_phase:.1f} s | card {card}")
        return {"launches": first["launches"]["vq_nearest"],
                "per_step": {n: c / again["steps"] for n, c in again["launches"].items()}}
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------- (m)

# Phase (m)'s limits. The mel sidecar: the magnitudes (exp of the log mel)
# of the card's and the f32 CPU's within "mel_peak" of the sidecar's peak
# magnitude (tests/test_torch_prepare.py holds the CPU's to JAX's the same
# way, 1e-5; the card read 4.4e-07). The CLVP step, card (bf16 encoders, f32
# attention scores, pooling and loss) against the f32 CPU step at the same
# weights, 4 rows, dropout off, set as TRAIN_TOL was, a few times the largest
# of three runs' readings on an H100 80GB HBM3 at 700 W (PERF.md): loss
# 3.2e-05-5.6e-05, grad norm 6.1e-04-1.4e-03, least cosine of 449 tensors
# 0.99994-0.99995; the pooling and InfoNCE left under bf16 autocast read a
# loss 1.3e-03 apart. The eval hook's 10-step mel and waveform (bf16 trunk
# kernels, the causal kernel's latent) against the f32 CPU hook: phase
# (e)'s limits for the same tail (read 6.3e-03-6.5e-03 and 7.4e-03-7.6e-03).
RECIPE_TOL = {"mel_peak": 1e-5, "loss_rel": 2e-4, "grad_norm_rel": 5e-3, "min_cos": 0.9998,
              "named_cos": TRAIN_TOL["named_cos"], "eval mel": 2e-2, "eval wav": 3e-2}
RECIPE_STEPS, RECIPE_SAVE, RECIPE_BATCH = 8, 4, 32
# the ASR hook's transcripts and their pinyin (the card's machine may lack
# pypinyin, as the JAX recipe test's does: the manifest takes the pinyin)
RECIPE_TEXTS = {"你好世界朋友们": "ni3 hao3 shi4 jie4 peng2 you3 men5",
                "今天天气真不错": "jin1 tian1 tian1 qi4 zhen1 bu4 cuo4",
                "欢迎使用语音合成": "huan1 ying2 shi3 yong4 yu3 yin1 he2 cheng2"}


def _raw_recordings(root, recordings: int = 12, bursts: int = 3, seed: int = 11) -> None:
    """Seeded 32 kHz recordings, each `bursts` synthetic voices of 2-5 s
    between 0.8 s silences (pipeline vad splits each burst into a clip)."""
    from ttts_tpu_torch.data.audio import save_wav

    rng = np.random.default_rng(seed)
    root.mkdir(parents=True)
    sil = np.zeros(int(0.8 * 32000), np.float32)
    for r in range(recordings):
        parts = [sil]
        for b in range(bursts):
            parts += [synthetic_voice(float(rng.uniform(2.0, 5.0)), 32000,
                                      seed=seed + 10 * r + b), sil]
        save_wav(root / f"rec{r:02d}.wav", np.concatenate(parts), 32000)


def _asr(clips, manifest, root) -> None:
    """`pipeline asr` through a transcribe(path) module the phase writes to
    `root`, importable only during the call."""
    from ttts_tpu_torch.data.prepare import pipeline

    texts, name = list(RECIPE_TEXTS), "recipe_chip_asr"
    (root / f"{name}.py").write_text(
        f"TEXTS = {texts!r}\n"
        "def transcribe(path):\n"
        "    return TEXTS[sum(map(ord, path)) % len(TEXTS)]\n")
    sys.path.insert(0, str(root))
    try:
        pipeline.main(["asr", "--in-dir", str(clips), "--out", str(manifest), "--hook", name])
    finally:
        sys.path.remove(str(root))
        sys.modules.pop(name, None)


def _prepare(root, codec_ckpt, card: str) -> dict:
    """(m) 1: vad → asr → bpe-corpus → mel → vq on the card; VQ launches =
    clips, plain calls 0; one clip's codes and mel against the f32 CPU's."""
    from ttts_tpu_torch.config import default_config
    from ttts_tpu_torch.data.audio import load_wav
    from ttts_tpu_torch.data.manifest import load_sidecar, read_manifest, write_manifest
    from ttts_tpu_torch.data.prepare import pipeline
    from ttts_tpu_torch.ops.cuda import vq
    from ttts_tpu_torch.ops.mel import acoustic_mel_spectrogram

    t0 = time.perf_counter()
    _raw_recordings(root / "raw")
    clips, manifest = root / "clips", root / "data.jsonl"
    pipeline.main(["vad", "--in-dir", str(root / "raw"), "--out-dir", str(clips)])
    _asr(clips, manifest, root)
    rows = [{**r, "text": RECIPE_TEXTS[r["text"]]} for r in read_manifest(manifest)]
    n = len(rows)
    if n != len(list(clips.glob("*.wav"))) or n < RECIPE_BATCH:
        raise RuntimeError(f"(m) vad/asr: {n} rows")
    write_manifest(manifest, rows)
    pipeline.main(["bpe-corpus", str(manifest), "--out", str(root / "bpe.txt")])
    secs = sum(len(load_wav(r["path"])[0]) for r in rows) / 32000
    t_host = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipeline.main(["mel", "--manifest", str(manifest)])
    torch.cuda.synchronize()
    t_mel = time.perf_counter() - t0
    plain = []
    real_plain = vq.vq_nearest_plain
    vq.vq_nearest_plain = lambda x, cb: plain.append(1) or real_plain(x, cb)
    reset_counts()
    try:
        t0 = time.perf_counter()
        pipeline.main(["vq", "--manifest", str(manifest), "--ckpt", str(codec_ckpt)])
        torch.cuda.synchronize()
        t_vq = time.perf_counter() - t0
    finally:
        vq.vq_nearest_plain = real_plain
    launches = counts()
    want = dict.fromkeys(KERNELS, 0)
    want["vq_nearest"] = n
    if launches != want or plain:
        raise RuntimeError(f"(m) pipeline vq launched {launches}, plain calls {len(plain)}; "
                           f"expected one VQ launch per clip ({n})")
    # the subcommand's time splits into the checkpoint's load (the GAN state,
    # optimizers included) and the clips: each part again, apart
    cfg = default_config()
    t0 = time.perf_counter()
    codec = pipeline.load_codec(str(codec_ckpt), cfg, torch.device("cuda"))
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    per_clip = []
    for r in rows:
        wav, _ = load_wav(r["path"], target_sr=cfg.audio.sampling_rate)
        t0 = time.perf_counter()
        pipeline.extract_codes(codec, wav, cfg.audio, torch.device("cuda"))
        per_clip.append((time.perf_counter() - t0) * 1e3)
    # one clip against the f32 CPU path, from the same checkpoint
    codec = pipeline.load_codec(str(codec_ckpt), cfg, torch.device("cpu"))
    wav, _ = load_wav(rows[0]["path"], target_sr=cfg.audio.sampling_rate)
    codes_cpu = pipeline.extract_codes(codec, wav, cfg.audio, torch.device("cpu"))
    codes_card = load_sidecar(rows[0]["path"], "vq")
    wav24, _ = load_wav(rows[0]["path"], target_sr=24000)
    with torch.no_grad():
        mel_cpu = acoustic_mel_spectrogram(torch.from_numpy(wav24)[None])[0].numpy()
    mel_card = load_sidecar(rows[0]["path"], "mel")
    mag = np.abs(np.exp(mel_card) - np.exp(mel_cpu)).max() / np.exp(mel_cpu).max()
    frames = [int(np.prod(load_sidecar(r["path"], "vq").shape)) for r in rows]
    log(f"(m) data preparation: {len(list((root / 'raw').glob('*.wav')))} recordings -> vad "
        f"{n} clips ({secs:.1f} s of audio), asr, bpe-corpus: {t_host:.2f} s on the host | mel "
        f"{n} sidecars {t_mel:.2f} s ({t_mel / n * 1e3:.2f} ms a clip) | vq {n} sidecars "
        f"{t_vq:.2f} s ({t_vq / n * 1e3:.2f} ms a clip, {min(frames)}-{max(frames)} codes; "
        f"again apart: the checkpoint's load {t_load:.2f} s, a clip's codes median "
        f"{np.median(per_clip):.2f} ms ({min(per_clip):.2f}-{max(per_clip):.2f}), wav read "
        f"to codes on the host), VQ kernel launches {launches['vq_nearest']} (one a clip), "
        f"plain version 0 times, no other kernel | clip 0 against the f32 CPU path: codes "
        f"{int((codes_card == codes_cpu).sum())}/{codes_cpu.size} equal, mel magnitudes "
        f"within {mag:.3e} of the peak (tol {RECIPE_TOL['mel_peak']}) | card {card}")
    if codes_card.shape != codes_cpu.shape or (codes_card != codes_cpu).any():
        raise RuntimeError("(m) the card's codes differ from the f32 CPU path's")
    if not mag <= RECIPE_TOL["mel_peak"]:
        raise RuntimeError(f"(m) the card's mel sidecar is {mag:.3e} from the CPU's")
    return {"manifest": str(manifest), "rows": rows,
            "vq_per_clip": {k: c / n for k, c in launches.items()}}


def _no_dropout(model: torch.nn.Module) -> torch.nn.Module:
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
        if isinstance(getattr(m, "dropout", None), float):
            m.dropout = 0.0
    return model


def _compare_clvp(cfg, sd, batch) -> None:
    """One CLVP loss and its gradients on the card (bf16 autocast) and the
    CPU (f32), at the same weights, dropout off; then the card's again with
    a planted precision fault, which RECIPE_TOL must refuse: no_autocast
    made a no-op, so the pooling, latents, similarities and InfoNCE run
    under bf16 autocast."""
    import contextlib
    import copy

    from ttts_tpu_torch.models import clvp
    from ttts_tpu_torch.train.steps import autocast, clvp_loss

    cpu = clvp.CLVP(cfg.clvp)
    cpu.load_state_dict(sd)
    cpu = _no_dropout(cpu).train()
    card = copy.deepcopy(cpu).cuda()
    names = [n for n, _ in cpu.named_parameters()]

    def step(model, dev):
        b = {k: v.to(dev) for k, v in batch.items()}
        with autocast(torch.device(dev), torch.bfloat16 if dev == "cuda" else None):
            loss = clvp_loss(model, b)
        return loss.item(), torch.autograd.grad(loss, list(model.parameters()),
                                                allow_unused=True)

    (loss_cpu, grads_cpu), (loss_card, grads_card) = step(cpu, "cpu"), step(card, "cuda")
    _hold_train("CLVP step", loss_card, loss_cpu, _grad_reading(names, grads_card, grads_cpu),
                [], RECIPE_TOL, "(m)")
    kept = clvp.no_autocast
    clvp.no_autocast = lambda device: contextlib.nullcontext()
    try:
        loss_card, grads_card = step(card, "cuda")
    finally:
        clvp.no_autocast = kept
    try:
        _hold_train("CLVP step, planted: pooling and InfoNCE under bf16 autocast", loss_card,
                    loss_cpu, _grad_reading(names, grads_card, grads_cpu), [], RECIPE_TOL,
                    "(m)")
    except RuntimeError:
        log("(m) RECIPE_TOL refuses the planted fault, as it must")
    else:
        raise RuntimeError("(m) RECIPE_TOL passed the planted precision fault")


def _train_clvp(cfg, data: dict, root, card: str) -> dict:
    """(m) 2: train.mains clvp at full width, a resume, the card against the
    CPU, the export served by TextToSpeech.from_checkpoints. → launches per
    step."""
    from ttts_tpu_torch.api import TextToSpeech
    from ttts_tpu_torch.data.datasets import CLVPDataset
    from ttts_tpu_torch.train import mains
    from ttts_tpu_torch.train.checkpoints import export_model

    t0 = time.perf_counter()
    tokens = lambda b: float(b["text"].numel() + b["speech_tokens"].numel())  # noqa: E731

    def make():
        return mains.clvp_trainer(cfg, data["manifest"], str(root / "clvp"), "cuda")

    first = _run_trainer(make, "CLVP training", tokens, tag="(m)")
    tr = first["trainer"]
    if tr.ckpt.all_steps()[-2:] != [RECIPE_SAVE, RECIPE_STEPS]:
        raise RuntimeError(f"(m) CLVP checkpoints {tr.ckpt.all_steps()}")
    tr.ckpt.path(RECIPE_STEPS).unlink()
    again = _run_trainer(make, f"CLVP resumed from step {RECIPE_SAVE}", tokens, tag="(m)")
    if again["steps"] != RECIPE_STEPS - RECIPE_SAVE or again["trainer"].step != RECIPE_STEPS:
        raise RuntimeError("(m) the CLVP resume did not continue from its checkpoint")
    for run in (first, again):
        if any(run["launches"].values()):
            raise RuntimeError(f"(m) CLVP training launched {run['launches']}")
    ds = CLVPDataset(data["manifest"])
    batch = ds.collate([ds[i] for i in range(RECIPE_BATCH)])
    wall, busy, nl = _training_busy(again["trainer"], batch)
    log(f"(m) CLVP: no kernel launched (its steps run under autograd: the masked plain "
        f"attention) | throughput over the resumed steps {again['per_s']:.0f} text+speech "
        f"tokens/s | 3 steady steps of batch {RECIPE_BATCH} ({batch['speech_tokens'].shape[1]} "
        f"codes): wall {wall:.1f} ms without the profiler, device busy {busy:.1f} ms in {nl} "
        f"launches under it: busy share {busy / wall:.3f} | card {card}")
    sd = {k: v.cpu() for k, v in again["trainer"].state.model.state_dict().items()}
    small = {k: torch.as_tensor(v[:4]).long() for k, v in batch.items()}
    _compare_clvp(cfg, sd, small)
    export_model("clvp", sd, root / "clvp.npz")
    tts = TextToSpeech.from_checkpoints(cfg, clvp=root / "clvp.npz", device="cuda")
    served = tts.clvp.state_dict()
    if any(not torch.equal(served[k].cpu(), v.to(torch.float16).to(served[k].dtype))
           for k, v in sd.items() if v.is_floating_point()):
        raise RuntimeError("(m) TextToSpeech.from_checkpoints(clvp=...) holds other weights")
    wav = tts.tts(TEXT, synthetic_voice(3.0, 44100, seed=4), 44100, preset="fast",
                  max_generate_length=200, seed=1)
    if not (wav.size and np.isfinite(wav).all()):
        raise RuntimeError("(m) the trained CLVP's rerank served a non-finite waveform")
    del tts
    log(f"(m) export_model('clvp') -> TextToSpeech.from_checkpoints(clvp=...) holds the "
        f"trained weights (f16 release) -> tts 'fast' (4 candidates reranked): {wav.size} "
        f"finite samples | CLVP part {time.perf_counter() - t0:.1f} s")
    return {n: c / first["steps"] for n, c in first["launches"].items()}


def _train_classifier(cfg, data: dict, root, card: str) -> dict:
    """(m) 3: train.mains classifier on clean / noise lists of the mel
    sidecars, misc classify with its export, pipeline filter-noise. →
    launches per step."""
    from ttts_tpu_torch.data.manifest import read_manifest
    from ttts_tpu_torch.data.prepare import misc, pipeline
    from ttts_tpu_torch.train import mains
    from ttts_tpu_torch.train.checkpoints import export_model

    t0 = time.perf_counter()
    paths = [r["path"] for r in data["rows"]]
    half = len(paths) // 2
    (root / "clean.txt").write_text("\n".join(paths[:half]) + "\n")
    (root / "noise.txt").write_text("\n".join(paths[half:]) + "\n")
    frames = lambda b: float(b["mel"].shape[0] * b["mel"].shape[1])  # noqa: E731
    run = _run_trainer(lambda: mains.classifier_trainer(
        cfg, str(root / "clean.txt"), str(root / "noise.txt"), str(root / "cls"), "cuda"),
        "classifier training", frames, tag="(m)")
    if any(run["launches"].values()):
        raise RuntimeError(f"(m) classifier training launched {run['launches']}")
    export_model("classifier", run["trainer"].state.model.state_dict(), root / "cls.npz")
    reset_counts()
    t1 = time.perf_counter()
    misc.main(["classify", "--manifest", data["manifest"], "--ckpt", str(root / "cls.npz"),
               "--out", str(root / "noise_files.txt")])
    torch.cuda.synchronize()
    t_cls = time.perf_counter() - t1
    flagged = [x for x in (root / "noise_files.txt").read_text().splitlines() if x]
    pipeline.main(["filter-noise", "--manifest", data["manifest"], "--noise-files",
                   str(root / "noise_files.txt"), "--out", str(root / "kept.jsonl")])
    kept = len(read_manifest(root / "kept.jsonl"))
    if kept != len(paths) - len(set(flagged) & set(paths)) or any(counts().values()):
        raise RuntimeError(f"(m) classify / filter-noise: kept {kept}, flagged {len(flagged)}, "
                           f"launches {counts()}")
    log(f"(m) classifier: {run['steps']} steps, no kernel launched | misc classify of "
        f"{len(paths)} clips on the card {t_cls:.2f} s ({t_cls / len(paths) * 1e3:.2f} ms a "
        f"clip; its attention, D=128, is outside the kernels' domain): {len(flagged)} flagged "
        f"-> filter-noise kept {kept} | classifier part {time.perf_counter() - t0:.1f} s | "
        f"card {card}")
    return {n: c / run["steps"] for n, c in run["launches"].items()}


def _eval_hook(cfg, data: dict, trained: dict, root, card: str, rows: list) -> dict:
    """(m) 4: make_diffusion_eval_fn through a diffusion Trainer with
    eval_freq 1 on phase (k)'s denoiser and frozen GPT: launches against the
    call sites, each kernel against its plain version at every shape the
    hook gave it (rows `<kernel>_eval_hook`), ms, and the 10-step hook
    against the f32 CPU hook."""
    import copy
    import types

    from ttts_tpu_torch.data.datasets import DiffusionDataset
    from ttts_tpu_torch.models.diffusion_net import AA_diffusion
    from ttts_tpu_torch.models.gpt import UnifiedVoice
    from ttts_tpu_torch.models.vocos import Vocos
    from ttts_tpu_torch.train import mains
    from ttts_tpu_torch.train.eval_hooks import make_diffusion_eval_fn

    ds = DiffusionDataset(data["manifest"])
    batch = ds.collate([ds[int(np.argmin(ds.lengths()))]])  # the shortest clip
    torch.manual_seed(0)
    vocos = Vocos(cfg.vocos)

    def models(device):
        """The frozen GPT, a sampler net (the hook loads the state's weights
        into it) and the seeded Vocos, on `device`."""
        gpt = UnifiedVoice(cfg.gpt)
        gpt.load_state_dict(trained["gpt"])
        return (gpt.to(device).eval(), AA_diffusion(cfg.diffusion_net),
                copy.deepcopy(vocos).to(device))

    gpt, sampler, voc = models("cuda")
    hook = make_diffusion_eval_fn(sampler, gpt, voc, batch, steps=50,
                                  amp_dtype=torch.bfloat16)
    seen = {}

    def eval_fn(step, state, writer):
        torch.cuda.synchronize()
        reset_counts()
        sites, undo = _watch_call_sites(sampler, gpt)
        try:
            t0 = time.perf_counter()
            with _PathShapes() as spy:
                mel, wav = hook(step, state, writer)
                torch.cuda.synchronize()
            seen.update(first_ms=(time.perf_counter() - t0) * 1e3, sites=dict(sites),
                        launches=counts(), mel=mel, wav=wav, step=step, state=state,
                        shapes=spy.shapes)
        finally:
            undo()

    one = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, train_steps=1,
                                                             save_freq=1))
    trainer = mains.diffusion_trainer(one, data["manifest"], trained["gpt"], str(root / "diff"),
                                      "cuda", eval_fn=eval_fn, eval_freq=1)
    trainer.state.model.load_state_dict(trained["diffusion"])
    trainer.train()
    if seen.get("step") != 1 or not (root / "diff" / "tb" / "eval" / "sample" / "1.wav").exists():
        raise RuntimeError("(m) the Trainer did not call the eval hook at step 1")
    sites, launches = seen["sites"], seen["launches"]
    want = dict.fromkeys(KERNELS, 0)
    for n in ("flash_attention_bias", "scale_shift_resblock", "flash_attention_causal"):
        want[n] = sites[n]
    if launches != want or sites["flash_attention_causal"] != cfg.gpt.layers or not all(
            want[n] for n in ("flash_attention_bias", "scale_shift_resblock")):
        raise RuntimeError(f"(m) eval hook launches {launches}, call sites {sites}")
    # each kernel at every shape the hook gave it (the trunk's ragged T, the
    # conditioning encoders', the frozen GPT's latent)
    if any(bool(seen["shapes"][n]) != bool(launches[n]) for n in HELD):
        raise RuntimeError(f"(m) eval hook shapes {seen['shapes']}, launches {launches}")
    _hold_path_shapes(rows, seen["shapes"], "(m)", "diffusion eval hook", "_eval_hook")
    if not (torch.isfinite(seen["mel"]).all() and torch.isfinite(seen["wav"]).all()):
        raise RuntimeError("(m) the eval hook gave a non-finite mel or waveform")
    state = seen["state"]
    ms = median_ms(lambda: hook(2, state, None), reps=3, warmup=1)
    # 10 steps, shared noise: the card's hook against the f32 CPU hook
    t = batch["mel"].shape[1]
    noise = torch.randn((1, t, batch["mel"].shape[-1]), generator=torch.Generator().manual_seed(3))
    hook10 = make_diffusion_eval_fn(AA_diffusion(cfg.diffusion_net), gpt, voc, batch, steps=10,
                                    amp_dtype=torch.bfloat16)
    mel_card, wav_card = hook10(3, state, None, noise=noise)
    gpt_c, sampler_c, voc_c = models("cpu")
    net_c = AA_diffusion(cfg.diffusion_net)
    net_c.load_state_dict(trained["diffusion"])
    hook_cpu = make_diffusion_eval_fn(sampler_c, gpt_c, voc_c, batch, steps=10)
    mel_cpu, wav_cpu = hook_cpu(3, types.SimpleNamespace(model=net_c), None, noise=noise)
    errs = {"eval mel": rel_err(mel_card.float().cpu(), mel_cpu),
            "eval wav": rel_err(wav_card.float().cpu(), wav_cpu)}
    log(f"(m) eval hook through a diffusion Trainer (eval_freq 1) on phase (k)'s denoiser and "
        f"frozen GPT, {t} mel frames, 50 DPM++(2M) steps: launches "
        f"{ {n: c for n, c in launches.items() if c} } = the call sites' calls (the causal "
        f"kernel once per GPT layer: no call site took its plain version) | first call "
        f"{seen['first_ms']:.1f} "
        f"ms, steady median {ms:.1f} ms | writer files under tb/eval | 10 steps, shared noise, "
        f"card vs f32 CPU: mel rel {errs['eval mel']:.3e} (tol {RECIPE_TOL['eval mel']}), wav "
        f"rel {errs['eval wav']:.3e} (tol {RECIPE_TOL['eval wav']}) | card {card}")
    for k, v in errs.items():
        if not v <= RECIPE_TOL[k]:
            raise RuntimeError(f"(m) {k}: {v:.3e} > {RECIPE_TOL[k]}")
    return {n: c for n, c in launches.items()}


def phase_recipe(card: str, rows: list, trained: dict, codec_root) -> dict:
    """(m) The rest of the five-stage recipe at default_config() widths on
    the card, through the port's CLIs and trainers: data preparation from
    raw recordings (vq through phase (l)'s codec checkpoint), CLVP and
    classifier training, and the diffusion eval hook on phase (k)'s models.
    → the launches of the eval hook's call, of `pipeline vq` per clip and
    of a CLVP and a classifier step."""
    import pathlib
    import shutil
    import tempfile

    from ttts_tpu_torch.config import default_config

    t_phase = time.perf_counter()
    base = default_config()
    cfg = dataclasses.replace(base, train=dataclasses.replace(
        base.train, train_steps=RECIPE_STEPS, save_freq=RECIPE_SAVE, batch_size=RECIPE_BATCH))
    root = pathlib.Path(tempfile.mkdtemp(prefix="ttts_recipe_"))
    try:
        data = _prepare(root, pathlib.Path(codec_root) / "ckpt", card)
        clvp = _train_clvp(cfg, data, root, card)
        classifier = _train_classifier(cfg, data, root, card)
        launches = _eval_hook(cfg, data, trained, root, card, rows)
        log(f"(m) phase (m) {time.perf_counter() - t_phase:.1f} s | card {card}")
        return {"eval_hook": launches, "vq_per_clip": data["vq_per_clip"], "clvp": clvp,
                "classifier": classifier}
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------- (n)

# Phase (n)'s limit on the card against the f32 CPU path at full width
# (waveforms, the style vector, the semantic content, the DVAE's mel), 1e-5
# relative: on an H100 80GB HBM3 (700 W) the largest reading was 1.22e-06
# (RVQ1's semantic content; the waveforms 2.55e-07, the DVAE's mel
# 1.48e-07), the same in each run, 8x under it and 100x under phase (h)'s
# CODEC_TOL. Codes: equal but where the CPU's two nearest distances lie
# within LIB_TIE relative (counted and printed; 0 so far).
LIB_TOL, LIB_TIE = 1e-5, 1e-5
LIB_VOICES, LIB_SECONDS = 4, 5.0


def _lib_call(what: str, fn, searches: int, shapes: set):
    """fn() once on the card, its VQ searches (quantizer calls of vq.nearest)
    equal to `searches` and to the VQ kernel's launches, the plain version
    never called, no other kernel launched; the search shapes join
    `shapes`. → (fn's result, launches)."""
    torch.cuda.synchronize()
    reset_counts()
    with _VqSpy() as spy:
        out = fn()
        torch.cuda.synchronize()
    launches = counts()
    others = {n: c for n, c in launches.items() if n != "vq_nearest" and c}
    log(f"(n) {what}: VQ searches {spy.calls} (expected {searches}), VQ kernel launches "
        f"{launches['vq_nearest']}, plain version calls {spy.plain}, other kernels "
        f"{others or 0}")
    if spy.calls != searches or launches["vq_nearest"] != searches or spy.plain or others:
        raise AssertionError(f"(n) {what}: {spy.calls} searches, {launches} launches, "
                             f"{spy.plain} plain calls")
    shapes |= spy.shapes
    return out, launches["vq_nearest"]


def _codes_against_cpu(what: str, got: torch.Tensor, want: torch.Tensor, x, cb) -> int:
    """The card's codes against the CPU's (b-major, as the CPU search's rows
    x (N, D) of codebook cb): a mismatch only where the CPU's two nearest
    distances lie within LIB_TIE relative. → the mismatches."""
    got, want = got.cpu().reshape(-1), want.reshape(-1)
    mism = (got != want).nonzero().reshape(-1)
    near = 0
    if len(mism):
        xs = x[mism].float()
        dist = ((xs * xs).sum(1, keepdim=True) - 2.0 * (xs @ cb.float().T)
                + (cb.float() * cb.float()).sum(1)[None])
        two = dist.topk(2, dim=1, largest=False).values
        near = int(((two[:, 1] - two[:, 0]) <= LIB_TIE * two[:, 0].abs()).sum())
    log(f"(n) {what} codes, card vs CPU: {len(mism)}/{want.numel()} differ, {near} of them "
        f"near-ties (the CPU's two nearest within {LIB_TIE} relative; tolerance: no other)")
    if len(mism) != near:
        raise AssertionError(f"(n) {what}: {len(mism) - near} codes differ beyond a near-tie")
    return len(mism)


def _hold_lib_vq(rows, name: str, shape, card: str) -> None:
    """The VQ kernel against its plain version at a shape a model call gave
    it, read as phase (c) reads VQ (a row of the kernel table as `name`),
    timed beside cuBLAS's x @ cb.T alone (a floor, not the same function)."""
    from ttts_tpu_torch.ops.cuda.vq import vq_nearest_plain

    n, bins, d = shape
    fn = wrapper("vq_nearest")
    x, cb = _vq_inputs(torch.Generator("cuda").manual_seed(31 + n), n, bins, d)
    m = _vq_reading(x, cb, fn(x, cb))
    torch.cuda.synchronize()
    _timed(rows, name,
           f"N={n} bins={bins} D={d} f32 (phase (n)): mismatches {m['mism']} (near-ties "
           f"{m['near']}; tolerance: a mismatch only on a <=1e-5 relative distance tie, the exact "
           "tie to index 3), distance gap", m, "wrong", 0,
           partial(fn, x, cb), partial(vq_nearest_plain, x, cb), None,
           (2 * n * bins * d, (n * d + bins * d + n) * 4, PEAK_F32))
    row = rows[-1]
    log(f"(n) {name} device time (torch.profiler): kernel {device_us(row['run'])} | plain "
        f"{device_us(row['run_plain'])} | floor, x @ cb.T alone (cuBLAS f32, TF32 off) "
        f"{device_us(lambda: x @ cb.T)} | card {card}")


def _vq_edges(shapes) -> None:
    """The VQ kernel against its plain version at every (N, bins, D) the
    phase's calls gave it and at D=1024's edges: one row (39 rows of its
    40-row tile never written) and 41 rows (a ragged second tile)."""
    fn = wrapper("vq_nearest")
    for n, bins, d in sorted(shapes | {(1, 1024, 1024), (41, 1024, 1024)}):
        x, cb = _vq_inputs(torch.Generator("cuda").manual_seed(7 + n + d), n, bins, d)
        m = _vq_reading(x, cb, fn(x, cb))
        log(f"(n) VQ kernel vs plain, N={n} bins={bins} D={d}: wrong {m['wrong']:g} (tol 0), "
            f"mismatches {m['mism']} (near-ties {m['near']}), distance gap {m['max_abs']:.3e}")
        if m["wrong"]:
            raise AssertionError(f"(n) VQ at N={n} bins={bins} D={d}: {m}")


def _lib_voices():
    """The seeded 5 s voices at 32 kHz (B, T)."""
    return torch.stack([torch.from_numpy(synthetic_voice(LIB_SECONDS, 32000, seed=30 + i))
                        for i in range(LIB_VOICES)])


def _rvq1_part(card: str, shapes: set) -> dict:
    """RVQ1 at its defaults on the seeded voices: the training forward (the
    k-means init, then the search) on a seeded distillation target, then
    extract_code, decode of the codes and infer with the trained codebook;
    the card against the f32 CPU path (codes of every clip; the style and
    the semantic content; clip 0's infer and decode waveforms, shared
    noise); median ms of each call."""
    import copy

    from ttts_tpu_torch.models.rvq1 import RVQ1
    from ttts_tpu_torch.ops.mel import vits_spectrogram

    spec = vits_spectrogram(_lib_voices(), 2048, 640, 2048).transpose(1, 2)  # (4, 250, 1025)
    b, t = spec.shape[:2]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(21)
        cpu = nonzero_proj_out(RVQ1()).eval()
    gpu = copy.deepcopy(cpu).cuda()
    g = torch.Generator().manual_seed(22)
    hubert = torch.randn(b, t, 1024, generator=g)
    spec_g, hubert_g = spec.cuda(), hubert.cuda()
    out, n_train = _lib_call(
        f"RVQ1 training forward (B={b}, T={t}: the k-means init, then the search)",
        lambda: gpu(spec_g, hubert_g, train=True, generator=torch.Generator().manual_seed(23)),
        2, shapes)
    o, commit, _, stats, quantized, sem = out
    if not all(bool(torch.isfinite(v).all()) for v in (o, commit, sem, quantized, *stats)):
        raise AssertionError("(n) RVQ1 training forward: non-finite outputs")
    state = gpu.quantizer.state()
    cpu.quantizer.set_state(type(state)(*(v.cpu() for v in (
        state.embed, state.embed_avg, state.cluster_size, state.inited))))
    with torch.no_grad():
        codes_g, n_extract = _lib_call(f"RVQ1 extract_code (B={b})",
                                       lambda: gpu.extract_code(spec_g), 1, shapes)
        wav_d, n_decode = _lib_call(f"RVQ1 decode of those codes (B={b})",
                                    lambda: gpu.decode(codes_g.transpose(0, 1), spec_g,
                                                       generator=torch.Generator().manual_seed(1)),
                                    0, shapes)
        wav_i, n_infer = _lib_call(f"RVQ1 infer (B={b})",
                                   lambda: gpu.infer(spec_g,
                                                     generator=torch.Generator().manual_seed(2)),
                                   1, shapes)
        want = (b, 2 * -(-t // 2) * 640, 1)
        if tuple(wav_d.shape) != want or tuple(wav_i.shape) != want or not (
                torch.isfinite(wav_d).all() and torch.isfinite(wav_i).all()):
            raise AssertionError(f"(n) RVQ1 waveforms {tuple(wav_d.shape)}, "
                                 f"{tuple(wav_i.shape)} (want {want})")
        ms = {"extract_code": median_ms(lambda: gpu.extract_code(spec_g), reps=5, warmup=1),
              "decode": median_ms(lambda: gpu.decode(codes_g.transpose(0, 1), spec_g),
                                  reps=5, warmup=1),
              "infer": median_ms(lambda: gpu.infer(spec_g), reps=5, warmup=1)}
        # the card against the f32 CPU path
        with _VqSpy() as spy:
            codes_c = cpu.extract_code(spec)
        mism = _codes_against_cpu("RVQ1", codes_g, codes_c, *spy.last)
        errs = {}
        ge_c = cpu.ref_enc(spec)
        ge_g = gpu.ref_enc(spec_g)
        errs["style ge"] = rel_err(ge_g, ge_c)
        errs["semantic content"] = rel_err(gpu.semantic_enc(spec_g, g=ge_g),
                                           cpu.semantic_enc(spec, g=ge_c))
        noise = torch.randn(1, 2 * -(-t // 2), 192, generator=g)
        errs["infer clip 0"] = rel_err(gpu.infer(spec_g[:1], noise=noise.cuda()),
                                       cpu.infer(spec[:1], noise=noise))
        c0 = codes_c[:1].transpose(0, 1)
        errs["decode clip 0"] = rel_err(gpu.decode(c0.cuda(), spec_g[:1], noise=noise.cuda()),
                                        cpu.decode(c0, spec[:1], noise=noise))
    ms["training forward"] = median_ms(
        lambda: gpu(spec_g, hubert_g, train=True, generator=torch.Generator().manual_seed(24)),
        reps=3, warmup=1)
    log(f"(n) RVQ1 at its defaults (spec 1025, HuBERT 1024, 768-wide text encoder, 1024 codes "
        f"of D=1024), {b} voices of {LIB_SECONDS:g} s ({t} frames, {codes_g.shape[-1]} codes "
        f"each): commit loss {commit.item():.4e}, semantic loss {sem.item():.4e}; median ms "
        + ", ".join(f"{k} {v:.2f}" for k, v in ms.items())
        + f" (CUDA events; {card})")
    log("(n) RVQ1 card vs f32 CPU, relative error (tol "
        f"{LIB_TOL}): " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    bad = [k for k, v in errs.items() if not v <= LIB_TOL]
    if bad:
        raise AssertionError(f"(n) RVQ1 card vs CPU over {LIB_TOL}: {bad}")
    return {"launches": n_train + n_extract + n_decode + n_infer, "mismatches": mism,
            "per_call": {"train": n_train, "extract_code": n_extract, "decode": n_decode,
                         "infer": n_infer}}


def _dvae_part(card: str, shapes: set) -> dict:
    """DiscreteVAE at its defaults on the voices resampled to 22.05 kHz
    through the tacotron mel: the training forward (the k-means init, then
    the search), then get_codebook_indices and decode_codes; the card
    against the f32 CPU path; median ms of each call."""
    import copy

    from ttts_tpu_torch.models.dvae import DiscreteVAE
    from ttts_tpu_torch.ops.mel import tacotron_mel_spectrogram
    from ttts_tpu_torch.ops.resample import resample

    mel = tacotron_mel_spectrogram(resample(_lib_voices(), 32000, 22050)).transpose(1, 2)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(25)
        cpu = DiscreteVAE().eval()
    gpu = copy.deepcopy(cpu).cuda()
    mel_g = mel.cuda()
    (recon, commit, out), n_train = _lib_call(
        f"DVAE training forward (mel {tuple(mel.shape)}: the k-means init, then the search)",
        lambda: gpu(mel_g, train=True, generator=torch.Generator().manual_seed(26)), 2, shapes)
    if not all(bool(torch.isfinite(v).all()) for v in (recon, commit, out)):
        raise AssertionError("(n) DVAE training forward: non-finite outputs")
    state = gpu.quantizer.state()
    cpu.quantizer.set_state(type(state)(*(v.cpu() for v in (
        state.embed, state.embed_avg, state.cluster_size, state.inited))))
    with torch.no_grad():
        codes_g, n_idx = _lib_call("DVAE get_codebook_indices",
                                   lambda: gpu.get_codebook_indices(mel_g), 1, shapes)
        rec_g, n_dec = _lib_call("DVAE decode_codes", lambda: gpu.decode_codes(codes_g), 0,
                                 shapes)
        ms = {"get_codebook_indices": median_ms(lambda: gpu.get_codebook_indices(mel_g),
                                                reps=5, warmup=1),
              "decode_codes": median_ms(lambda: gpu.decode_codes(codes_g), reps=5, warmup=1)}
        with _VqSpy() as spy:
            codes_c = cpu.get_codebook_indices(mel)
        mism = _codes_against_cpu("DVAE", codes_g, codes_c, *spy.last)
        errs = {"decode_codes": rel_err(gpu.decode_codes(codes_c.cuda()), cpu.decode_codes(codes_c)),
                "eval forward output": rel_err(gpu(mel_g)[2], cpu(mel)[2])}
    ms["training forward"] = median_ms(
        lambda: gpu(mel_g, train=True, generator=torch.Generator().manual_seed(27)),
        reps=3, warmup=1)
    log(f"(n) DVAE at its defaults (80 mels, 512 codes of D=512, 3 stride-2 layers), "
        f"{LIB_VOICES} voices at 22.05 kHz ({mel.shape[1]} mel frames, {codes_g.shape[1]} codes "
        f"each): recon {recon.item():.4e}, commit {commit.item():.4e}; median ms "
        + ", ".join(f"{k} {v:.2f}" for k, v in ms.items()) + f" (CUDA events; {card})")
    log(f"(n) DVAE card vs f32 CPU, relative error (tol {LIB_TOL}): "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    bad = [k for k, v in errs.items() if not v <= LIB_TOL]
    if bad or tuple(rec_g.shape) != (LIB_VOICES, codes_g.shape[1] * 8, 80):
        raise AssertionError(f"(n) DVAE: over {LIB_TOL} {bad}, decode {tuple(rec_g.shape)}")
    return {"launches": n_train + n_idx + n_dec, "mismatches": mism,
            "per_call": {"train": n_train, "get_codebook_indices": n_idx, "decode_codes": n_dec}}


def _diffusion_tts_train(card: str) -> None:
    """One DiffusionTts training forward and backward at its defaults on the
    card, f32, draws injected (row 0 unconditioned, trunk layer 3 dropped):
    finite loss and grad norm, and no kernel launched (autograd records
    every call, so each dispatch takes its plain version)."""
    from ttts_tpu_torch.models.diffusion_tts_v1 import DiffusionTts

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(28)
        model = nonzero_proj_out(DiffusionTts()).cuda().train()
    g = torch.Generator().manual_seed(29)
    x = torch.randn(2, 200, 100, generator=g).cuda()
    target = torch.randn(2, 200, 200, generator=g).cuda()
    codes = torch.randint(0, 8193, (2, 50), generator=g).cuda()
    cond = torch.randn(2, 300, 100, generator=g).cuda()
    t = torch.tensor([10.0, 600.0], device="cuda")
    keep = [i != 3 for i in range(len(model.layers))]

    def step():
        out, mel_pred = model(x, t, codes, cond, return_code_pred=True, train=True,
                              uncond=torch.tensor([True, False]), layer_keep=keep)
        loss = (out - target).square().mean() + mel_pred.square().mean()
        grads = torch.autograd.grad(loss, [p for p in model.parameters() if p.requires_grad],
                                    allow_unused=True)
        return loss, torch.sqrt(sum(gr.square().sum() for gr in grads if gr is not None))

    torch.cuda.synchronize()
    reset_counts()
    loss, norm = step()
    torch.cuda.synchronize()
    launched = {n: c for n, c in counts().items() if c}
    ms = median_ms(step, reps=3, warmup=1)
    log(f"(n) DiffusionTts training forward + backward at its defaults (512 wide, 8 layers, "
        f"B=2, T=200, 50 codes): loss {loss.item():.4e}, grad norm {norm.item():.4e}, kernel "
        f"launches {launched or 0} (expected none: autograd) | {ms:.2f} ms (CUDA events; {card})")
    if launched or not (math.isfinite(loss.item()) and math.isfinite(norm.item())):
        raise AssertionError(f"(n) DiffusionTts training: loss {loss.item()}, norm "
                             f"{norm.item()}, launches {launched}")


def phase_library(card: str, rows: list) -> dict:
    """(n) The model library at full width: RVQ1 and DiscreteVAE (the VQ
    kernel at D=1024 and D=512), then DiffusionTts's training step. →
    launches of the VQ kernel in each model's calls."""
    t_phase = time.perf_counter()
    shapes: set = set()
    rvq1 = _rvq1_part(card, shapes)
    dvae = _dvae_part(card, shapes)
    log(f"(n) VQ search shapes (N, bins, D) of the phase's calls: {sorted(shapes)}")
    _vq_edges(shapes)
    for name, d in (("vq_nearest_rvq1", 1024), ("vq_nearest_dvae", 512)):
        _hold_lib_vq(rows, name, max(s for s in shapes if s[2] == d), card)
    _diffusion_tts_train(card)
    log(f"(n) phase (n) {time.perf_counter() - t_phase:.1f} s | card {card}")
    return {"rvq1": rvq1, "dvae": dvae}


# ---------------------------------------------------------------------- (o)

MULTI_BATCH = {"gpt": 4, "gan": 2}


def _one_step(make, what: str) -> dict:
    """One step of the trainer `make()` builds (its train_steps is 1),
    synchronised: → its metrics, state dict on the CPU and kernel launches."""
    trainer = make()
    reset_counts()
    trainer.train()
    torch.cuda.synchronize()
    launches = counts()
    metrics = {k: float(v) for k, v in trainer.history[-1].items()
               if k not in ("step", "seconds")}
    state = {k: v.detach().cpu().clone() if torch.is_tensor(v) else v
             for k, v in _flat_state(trainer.state.state_dict()).items()}
    mesh = trainer.step_fn.keywords.get("mesh") if isinstance(trainer.step_fn, partial) else None
    launched = {n: c for n, c in launches.items() if c}
    log(f"(o) {what}: one step, {'mesh ' + str(tuple(mesh.mesh.shape)) if mesh else 'no mesh'}"
        f", metrics {metrics}, launches {launched or 0}")
    return {"metrics": metrics, "state": state, "launches": launches}


def _flat_state(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_state(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat_state(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


def _same_step(what: str, a: dict, b: dict) -> None:
    if a["metrics"] != b["metrics"]:
        raise AssertionError(f"(o) {what}: metrics differ with the mesh: {a['metrics']} vs "
                             f"{b['metrics']}")
    diff = [k for k in a["state"] if torch.is_tensor(a["state"][k])
            and not torch.equal(a["state"][k], b["state"][k])]
    if diff or a["state"].keys() != b["state"].keys():
        raise AssertionError(f"(o) {what}: state differs with the mesh: {diff[:8]}")
    if a["launches"] != b["launches"]:
        raise AssertionError(f"(o) {what}: launches {a['launches']} vs {b['launches']}")


def _multi_training(root, tag: str) -> dict:
    """One GPT Trainer step and one codec GAN Trainer step through
    train.mains at default_config() widths: without a process group (no
    mesh), or in one (the mesh of cfg.mesh, the data-parallel all-reduce)."""
    from ttts_tpu_torch.config import default_config
    from ttts_tpu_torch.train import mains

    base = default_config()
    out = {}
    for what, make, manifest in (("gpt", mains.gpt_trainer, root / "train.jsonl"),
                                 ("gan", mains.vqvae_trainer, root / "wavs.jsonl")):
        cfg = dataclasses.replace(base, train=dataclasses.replace(
            base.train, train_steps=1, save_freq=1, batch_size=MULTI_BATCH[what]))
        logs = str(root / f"{what}_{tag}")
        out[what] = _one_step(lambda: make(cfg, str(manifest), logs, "cuda"),
                              f"{what} trainer ({tag})")
    return out


def _decode_shards(rows) -> dict:
    """The decode kernel on each tensor-parallel shard's own caches,
    allocated at (B, H/tp, max_len, dk) for tp = 2 and 4, on the head chunks
    of one full-width decode state: the shards' outputs, concatenated, equal
    the full launch's exactly, and the plain version within DECODE_TOL. →
    {tp: the kernel's launches through decode_attention_spmd on the shards'
    caches} (the counts are reset before those calls and read after them,
    so the full-cache and timing launches are not among them)."""
    from ttts_tpu_torch.ops.cuda.decode_attention import (
        decode_attention_plain,
        decode_attention_spmd,
        head_chunk,
    )

    fn = wrapper("decode_attention")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator(device="cuda").manual_seed(7)
    b, h, dk, ml = 4, 8, 64, 563
    bf = partial(torch.randn, generator=g, device="cuda")
    kc, vc = bf(b, h, ml, dk).to(torch.bfloat16), bf(b, h, ml, dk).to(torch.bfloat16)
    shard_launches = {2: 0, 4: 0}
    for pos in (0, 281, ml - 1):
        q, uk, uv = (bf(b, h, dk).to(torch.bfloat16) for _ in range(3))
        kf, vf = kc.clone(), vc.clone()
        full = fn(q, uk, uv, kf, vf, pos)
        want = decode_attention_plain(q.float(), uk.float(), uv.float(), kc.float(),
                                      vc.float(), pos)
        for tp in (2, 4):
            outs, caches, spmd = [], [], []
            for s in range(tp):
                hs = head_chunk(h, s, tp)
                # each shard's caches allocated at its own shape, not views
                ks = torch.empty(b, h // tp, ml, dk, dtype=torch.bfloat16, device="cuda")
                vs = torch.empty_like(ks)
                ks.copy_(kc[:, hs])
                vs.copy_(vc[:, hs])
                spmd.append(partial(decode_attention_spmd, q[:, hs], uk[:, hs], uv[:, hs], ks,
                                    vs, pos, step=fn))
                caches.append((ks, vs))
            reset_counts()
            outs = [call() for call in spmd]
            shard_launches[tp] += count("decode_attention")
            got = torch.cat(outs, dim=1)
            if not (torch.equal(got, full) and torch.equal(torch.cat([c[0] for c in caches], 1), kf)
                    and torch.equal(torch.cat([c[1] for c in caches], 1), vf)):
                raise AssertionError(f"(o) decode tp={tp} pos={pos}: shards differ from the "
                                     "full-cache launch")
            # the timed shard: shard 0's caches and rows
            hs = head_chunk(h, 0, tp)
            ks, vs = caches[0]
            q0, uk0, uv0 = q[:, hs].contiguous(), uk[:, hs].contiguous(), uv[:, hs].contiguous()
            kp, vp = ks.clone(), vs.clone()
            bh = b * (h // tp) * dk * 2
            _timed(rows, f"decode_attention_tp{tp}",
                   f"B={b} H={h}/{tp} dk={dk} max_len={ml} pos={pos} bf16 shard caches, "
                   f"concatenated = full launch", compare(got, want), "excess", DECODE_TOL,
                   partial(fn, q0, uk0, uv0, ks, vs, pos),
                   partial(decode_attention_plain, q0, uk0, uv0, kp, vp, pos),
                   partial(sdpa, q0[:, :, None], ks[:, :, :pos + 1], vs[:, :, :pos + 1]),
                   (4 * b * (h // tp) * (pos + 1) * dk, 6 * bh + 2 * pos * bh))
    for tp in (2, 4):  # device time at the last position, the path's longest
        row = [r for r in rows if r["name"] == f"decode_attention_tp{tp}"][-1]
        log(f"(o) decode_attention_tp{tp} device time at pos {ml - 1} (torch.profiler): "
            f"kernel {device_us(row['run'])} | plain {device_us(row['run_plain'])} | library "
            f"(SDPA on the shard's cache) {device_us(row['run_library'])}")
    return shard_launches


def phase_multigpu(card: str, rows: list) -> dict:
    """(o) Multi-GPU (ttts_tpu_torch.parallel) at world size 1 under NCCL,
    the one card's: mesh serving and data-parallel training against the
    mesh-less calls, bit for bit; the decode kernel on tensor-parallel
    shards' caches; the NCCL all-reduce of the GPT's gradients. → the
    launches of the mesh serving call."""
    import datetime

    import torch.distributed as dist

    from ttts_tpu_torch.config import MeshConfig, default_config
    from ttts_tpu_torch.parallel import make_mesh
    from ttts_tpu_torch.parallel.mesh import all_reduce, batch_groups

    t_phase = time.perf_counter()
    root = pathlib.Path(tempfile.mkdtemp(prefix="ttts_multi_"))
    det = (torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled())
    # the same step twice must repeat bit for bit: cuDNN and SDPA's
    # deterministic algorithms
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _train_data(root, rows=8)
        _gan_data(root, rows=4)
        ref = _multi_training(root, "no process group")
        voice = synthetic_voice(5.0, 44100, seed=2)
        tts = make_tts("cuda")
        reset_counts()
        wavs = tts.tts_batch([TEXT, TEXT2], voice, 44100, max_generate_length=400, seed=3)
        plain_launches = counts()
        del tts
        torch.cuda.empty_cache()
        # NCCL at world size 1; no fallback: a failure here fails the phase
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"file://{root}/store", world_size=1,
                                rank=0, timeout=datetime.timedelta(seconds=60))
        try:
            log(f"(o) process group: backend {dist.get_backend()}, world {dist.get_world_size()}")
            mesh = make_mesh(MeshConfig(data=1, model=1))
            tts = make_tts("cuda", mesh=mesh)
            sites, undo = _watch_call_sites(tts.gpt, tts.clvp, tts.diffusion)
            reset_counts()
            t0 = time.perf_counter()
            got = tts.tts_batch([TEXT, TEXT2], voice, 44100, max_generate_length=400, seed=3)
            wall = time.perf_counter() - t0
            undo()
            launches = counts()
            _check_wavs(tts, got)
            if not all(np.array_equal(a, b) for a, b in zip(got, wavs)) or len(got) != 2:
                raise AssertionError("(o) mesh serving: waveforms differ from the mesh-less call")
            short = {n: (launches[n], sites[n]) for n in KERNELS if launches[n] != sites[n]}
            if launches != plain_launches or short:
                raise AssertionError(f"(o) mesh serving launches {launches} vs mesh-less "
                                     f"{plain_launches}; launches != call sites: {short}")
            log(f"(o) TextToSpeech(default_config(), mesh {tuple(mesh.mesh.shape)} "
                f"{mesh.mesh_dim_names}).tts_batch of 2 texts, fast: waveforms bit-equal to "
                f"the mesh-less call's, launches equal ({launches}) and = call sites, "
                f"wall {wall:.3f} s")
            del tts
            torch.cuda.empty_cache()
            shard_launches = _decode_shards(rows)
            log(f"(o) decode kernel launches on tensor-parallel shards' caches: "
                f"{shard_launches} (3 positions x tp shards)")
            dp = _multi_training(root, "NCCL mesh")
            for what in ("gpt", "gan"):
                _same_step(what, dp[what], ref[what])
            log(f"(o) GPT and GAN trainer steps through the NCCL all-reduce: losses, "
                f"parameters, optimizer and codebook states bit-equal to the mesh-less steps; "
                f"VQ launches {dp['gan']['launches']['vq_nearest']} = "
                f"{ref['gan']['launches']['vq_nearest']}")
            from ttts_tpu_torch.models.gpt import UnifiedVoice

            n = sum(p.numel() for p in UnifiedVoice(default_config().gpt).parameters())
            grads = [torch.randn(n, device="cuda")]
            ms = median_ms(lambda: all_reduce(grads, batch_groups(mesh)))
            raw = torch.randn(n, device="cuda")
            raw_ms = median_ms(lambda: dist.all_reduce(raw, group=batch_groups(mesh)[0]))
            log(f"(o) NCCL all-reduce of the GPT's gradients ({n} f32, {n * 4 / 1e6:.1f} MB) "
                f"at world 1: dist.all_reduce {raw_ms:.4f} ms, the steps' coalesced "
                f"all_reduce (flatten, reduce, mean, unflatten) {ms:.4f} ms (median of 20, "
                f"CUDA events; {card})")
        finally:
            dist.destroy_process_group()
    finally:
        torch.backends.cudnn.deterministic = det[0]
        torch.use_deterministic_algorithms(det[1])
        shutil.rmtree(root, ignore_errors=True)
    log(f"(o) phase (o) {time.perf_counter() - t_phase:.1f} s | card {card}")
    return {"serving": launches, "tp_shards": shard_launches}


# ---------------------------------------------------------------------- (p)

# The GPT's long-context training route (GPTConfig.flash_attention with
# attention dropout 0): attention.FlashCausal, whose forward is
# csrc/attention_fwd.cu, O and its rows' log2-sum-exp2 (mode "causal_lse"),
# and whose backward is csrc/attention_bwd.cu (mode "causal_bwd", two launches a
# call: the dQ kernel, then the dK/dV kernel). Each against its
# plain version on the same bf16 inputs (the backward's plain version fed
# the kernel forward's O and lse2), each limit on the metric beside it:
#   O:          rel_l2 <= ATTN_TOL, as phase (c)'s causal rows;
#   lse2:       max_abs <= LSE_TOL (log2 units): f32 statistics of the same
#               bf16 products, the order of the sums apart;
#   dq, dk, dv: rel_l2 <= BWD_TOL: the kernels round P and dS to bf16 before
#               their products, the plain version keeps f32. Its denominator
#               is at least GRAD_FLOOR of the whole gradient's norm: a tensor
#               zero analytically (dq and dk at T=1, where P = 1 and
#               dS = dO.v - dO.o = 0) is rounding noise on both sides.
# Readings on an H100 80GB HBM3 (700 W), correct kernels: O 1.8e-3 to
# 2.1e-3, lse2 <= 2.9e-6, dq / dk / dv 2.4e-3 to 3.3e-3; the planted faults
# of phase (g) read far above each limit.
# T at the edges of the 64-row warpgroups, the forward's 128-key tiles and
# 192-query blocks, the backward's 64-row walked tiles, its dK/dV kernel's
# 128-row blocks and its dQ kernel's 192-row blocks
FLASH_EDGES = (1, 63, 64, 65, 127, 128, 129, 191, 192, 193, 255, 256, 257)
FLASH_TS = FLASH_EDGES + (100, 164, 1796)
FLASH_D32_TS = FLASH_EDGES  # the same edges at D=32 (B=2, H=4)
FLASH_CTX = (64, 1796, 8, 64)  # B, T, H, D: batch 64 of text 256 + mel 1536 (T = 258 + 1538)
LSE_TOL, BWD_TOL, GRAD_FLOOR = 1e-4, 1e-2, 1e-3
FLASH_CLI_STEPS = 4  # steps of the gpt CLI's flash run
# launches of a flash-route GPT step (6 layers): one forward a layer, and a
# dQ and a dK/dV kernel a layer in the backward
FLASH_STEP_LAUNCHES = {"flash_causal_lse": 6, "flash_causal_bwd": 12}
# exp2 a second: the SFUs' 16 a clock per SM x 132 SMs at the 1.98 GHz boost clock
SFU_EXP2_S = 132 * 16 * 1.98e9


def _flash_inputs(g, b, t, h, d):
    """q, k, v as views of one fused (B, T, 3 H D) bf16 projection, as the
    GPT passes them, and a bf16 dO (B, T, H, D)."""
    from ttts_tpu_torch.ops.cuda.attention import split_qkv

    qkv = torch.randn(b, t, 3 * h * d, generator=g, device="cuda").to(torch.bfloat16)
    do = torch.randn(b, t, h, d, generator=g, device="cuda").to(torch.bfloat16)
    return qkv, (*split_qkv(qkv, h), do)


def _flash_bound(b, t, h, d, backward: bool):
    """(ms, by): the larger of the products over the bf16 peak, one exp2 a
    causal pair over the SFUs' rate and each input read and output written
    once over the memory rate. Forward: Q.K^T and P.V, reading q, k, v and
    writing O and lse2; backward: five products (S, dP, dV, dQ, dK),
    reading q, k, v, O, dO and lse2, writing dq, dk, dv."""
    pairs = b * h * t * (t + 1) / 2
    t_ops = max((10 if backward else 4) * pairs * d / PEAK_BF16, pairs / SFU_EXP2_S)
    nbytes = (8 if backward else 4) * b * t * h * d * 2 + b * h * t * 4
    t_bytes = nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _flash_readings(shape, g) -> dict:
    """compare() of the kernels' O, lse2, dq, dk, dv against the plain
    versions at (B, T, H, D); → {"o", "lse", "dq", "dk", "dv"} and the
    inputs."""
    from ttts_tpu_torch.ops.cuda.attention import (flash_causal_backward,
                                                   flash_causal_backward_plain,
                                                   flash_causal_forward,
                                                   flash_causal_forward_plain, split_qkv)

    qkv, (q, k, v, do) = _flash_inputs(g, *shape)
    o, lse = flash_causal_forward(q, k, v)
    o_p, lse_p = flash_causal_forward_plain(q, k, v)
    got = split_qkv(flash_causal_backward(q, k, v, o, lse, do), shape[2])
    want = flash_causal_backward_plain(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    m = {"o": compare(o, o_p), "lse": compare(lse, lse_p)}
    floor = GRAD_FLOOR * math.sqrt(sum(float(w.float().square().sum()) for w in want))
    for n, a, b in zip(("dq", "dk", "dv"), got, want):
        m[n] = compare(a, b)
        m[n]["rel_l2"] = float((a.float() - b.float()).norm()) / max(float(b.float().norm()),
                                                                     floor)
    return m


def _check_flash_kernels(rows, g) -> None:
    """The forward (O, lse2) and backward (dq, dk, dv) kernels against their
    plain versions at each T of FLASH_TS (H=8, D=64; B=4 at T=1796, where
    the plain version's f32 scores are 0.4 GB, B=2 below), and at D=32
    (B=2, H=4, each T of FLASH_D32_TS), each reading beside its limit; then
    the timed rows at FLASH_CTX."""
    from ttts_tpu_torch.ops.cuda.attention import (flash_causal_backward,
                                                   flash_causal_backward_plain,
                                                   flash_causal_forward,
                                                   flash_causal_forward_plain)

    worst = {"flash_causal_lse": 0.0, "flash_causal_bwd": 0.0}
    bad = []
    shapes = ([(2 if t < 1796 else 4, t, 8, 64) for t in FLASH_TS]
              + [(2, t, 4, 32) for t in FLASH_D32_TS])
    for shape in shapes:
        m = _flash_readings(shape, g)
        limits = {"o": ("rel_l2", ATTN_TOL), "lse": ("max_abs", LSE_TOL),
                  **{n: ("rel_l2", BWD_TOL) for n in ("dq", "dk", "dv")}}
        log(f"(p) B={shape[0]} T={shape[1]} H={shape[2]} D={shape[3]} bf16, kernel vs plain: "
            + ", ".join(f"{n} {metric} {m[n][metric]:.3e} (tol {tol})"
                        for n, (metric, tol) in limits.items()))
        bad += [(shape, n) for n, (metric, tol) in limits.items() if not m[n][metric] <= tol]
        worst["flash_causal_lse"] = max(worst["flash_causal_lse"], m["o"]["max_abs"],
                                        m["lse"]["max_abs"])
        worst["flash_causal_bwd"] = max([worst["flash_causal_bwd"]] +
                                        [m[n]["max_abs"] for n in ("dq", "dk", "dv")])
    if bad:
        raise AssertionError(f"(p) flash training kernels disagree with the plain versions: {bad}")
    # the backward from a thread with no current CUDA context, as autograd's
    # backward thread is until a torch kernel runs in it: the same gradient
    _, (q, k, v, do) = _flash_inputs(g, 2, 200, 8, 64)
    o, lse = flash_causal_forward(q, k, v)
    got = {}
    worker = threading.Thread(
        target=lambda: got.update(grad=flash_causal_backward(q, k, v, o, lse, do)))
    worker.start()
    worker.join()
    same = "grad" in got and torch.equal(got["grad"], flash_causal_backward(q, k, v, o, lse, do))
    log(f"(p) the backward from a fresh thread (B=2 T=200 H=8 D=64): equal to this thread's "
        f"{same}")
    if not same:
        raise AssertionError("(p) the backward fails or differs in a fresh thread")
    b, t, h, d = FLASH_CTX
    qkv, (q, k, v, do) = _flash_inputs(g, b, t, h, d)
    o, lse = flash_causal_forward(q, k, v)
    qt, kt, vt, dot = (z.transpose(1, 2) for z in (q, k, v, do))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # the library's backward alone: SDPA's graph kept, autograd.grad timed
    qg, kg, vg = (z.detach().requires_grad_() for z in (qt, kt, vt))
    out = sdpa(qg, kg, vg, is_causal=True)

    def sdpa_bwd():
        return torch.autograd.grad(out, (qg, kg, vg), dot, retain_graph=True)

    shape = f"B={b} T={t} H={h} D={d} bf16 (GPT reference context)"
    for name, run, run_plain, run_library, backward in (
            ("flash_causal_lse", partial(flash_causal_forward, q, k, v),
             partial(flash_causal_forward_plain, q, k, v),
             partial(sdpa, qt, kt, vt, is_causal=True), False),
            ("flash_causal_bwd", partial(flash_causal_backward, q, k, v, o, lse, do),
             partial(flash_causal_backward_plain, q, k, v, o, lse, do), sdpa_bwd, True)):
        ms, lms = median_ms(run), median_ms(run_library)
        torch.cuda.empty_cache()
        pms = median_ms(run_plain, reps=3, warmup=1)  # tens of GB of f32 scores a call
        torch.cuda.empty_cache()
        bms, by = _flash_bound(b, t, h, d, backward)
        log(f"(c) {name} {shape}: kernel {ms:.4f} ms, plain {pms:.4f} ms, library {lms:.4f} ms "
            f"(SDPA{' backward: autograd.grad of its kept graph' if backward else ''}), bound "
            f"{bms:.4f} ms ({by}; {bms / ms:.1%} of it)")
        rows.append({"name": name, "shape": shape, "max_abs_err": worst[name], "ms": ms,
                     "plain_ms": pms, "library_ms": lms, "bound_ms": bms, "bound_by": by,
                     "run": run, "run_plain": run_plain, "run_library": run_library})
    # forward plus backward as a training step calls them: FlashCausal
    # against SDPA, each one autograd call from the inputs
    from ttts_tpu_torch.ops.cuda.attention import FlashCausal

    qkv_g = qkv.detach().requires_grad_()
    grad = do.reshape(b, t, h * d)
    flash_ms = median_ms(lambda: torch.autograd.grad(FlashCausal.apply(qkv_g, h), qkv_g, grad))
    lib_ms = median_ms(lambda: torch.autograd.grad(sdpa(qg, kg, vg, is_causal=True),
                                                   (qg, kg, vg), dot))
    fb = sum(_flash_bound(b, t, h, d, bw)[0] for bw in (False, True))
    dev = {r["name"]: (device_us(r["run"]), device_us(r["run_library"])) for r in rows[-2:]}

    def ratio(name):  # kernel / library device time, where both were profiled
        a, b = (device_total_us(x) for x in dev[name])
        return f"{a / b:.3f}x" if a and b else "not measured"

    log(f"(p) forward + backward at {shape}: FlashCausal {flash_ms:.4f} ms, SDPA "
        f"{lib_ms:.4f} ms (CUDA events, one autograd call each), bound {fb:.4f} ms | device "
        f"time (torch.profiler): forward {dev['flash_causal_lse'][0]}, SDPA "
        f"{dev['flash_causal_lse'][1]} (kernel / SDPA {ratio('flash_causal_lse')}); backward "
        f"{dev['flash_causal_bwd'][0]}, SDPA's backward {dev['flash_causal_bwd'][1]} (kernels "
        f"/ SDPA's {ratio('flash_causal_bwd')})")


def _flash_batch(b: int, device="cuda"):
    """A seeded batch at the reference context: text 256 tokens, 1536 mel
    codes (a sequence of 258 + 1538 = 1796)."""
    g = np.random.default_rng(13)
    return {"text": torch.as_tensor(g.integers(1, 255, (b, 256)), device=device),
            "text_lengths": torch.full((b,), 256, device=device),
            "mel_codes": torch.as_tensor(g.integers(0, 1024, (b, 1536)), device=device),
            "wav_lengths": torch.full((b,), 1536 * 1024, device=device)}


def _flash_models(flash: bool, dropout: float, sd=None):
    """default_config()'s GPT on the card, train mode, attention dropout 0,
    resid / embedding dropout `dropout`, the flash route on or off."""
    from ttts_tpu_torch.config import default_config
    from ttts_tpu_torch.models.gpt import UnifiedVoice

    gcfg = dataclasses.replace(default_config().gpt, flash_attention=flash, attn_dropout=0.0,
                               dropout=dropout)
    torch.manual_seed(0)
    model = UnifiedVoice(gcfg)
    if sd is not None:
        model.load_state_dict(sd)
    return model.cuda().train()


def _flash_state(flash: bool, sd):
    from ttts_tpu_torch.config import default_config
    from ttts_tpu_torch.train.state import TrainState, make_adamw

    t = default_config().train
    return TrainState.create(_flash_models(flash, 0.1, sd), lambda ps: make_adamw(
        ps, t.lr, t.warmup_steps, t.betas, t.weight_decay, t.grad_clip, t.eps))


def _flash_steps(flash: bool, sd, batch, card: str, reps: int = 5) -> dict:
    """gpt_train_step (bf16 autocast, AdamW) at the reference context on a
    fresh TrainState: median step ms of `reps` after 2 warm-up steps, each
    ending in a synchronise; tokens/s; peak memory (and its part above what
    the process held before the timed steps: the state, the batch and other
    phases' tensors); launches over the timed steps; the busy share of 3
    more steps under torch.profiler."""
    from ttts_tpu_torch.train.steps import gpt_train_step

    state = _flash_state(flash, sd)
    step = partial(gpt_train_step, state, batch, amp_dtype=torch.bfloat16)
    for key in range(2):
        step(key)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2 ** 30
    reset_counts()
    secs, losses = [], []
    for key in range(2, 2 + reps):
        t0 = time.perf_counter()
        losses.append(float(step(key)["loss"]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = {n: c for n, c in counts().items() if c}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = float(np.median(secs)) * 1e3
    t0 = time.perf_counter()
    for key in range(3):
        step(10 + key)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    busy, n, _ = _device_busy(lambda: [step(20 + key) for key in range(3)])
    tokens = batch["text"].numel() + batch["mel_codes"].numel() + 4 * batch["text"].shape[0]
    out = {"ms": ms, "spread": (min(secs) * 1e3, max(secs) * 1e3), "tok_s": tokens / ms * 1e3,
           "peak": peak, "busy": busy / wall, "launches": launches, "reps": reps,
           "finite": all(math.isfinite(x) for x in losses)}
    log(f"(p) GPT train step, {'flash' if flash else 'SDPA'} route, B={batch['text'].shape[0]} "
        f"text 256 + mel 1536, bf16 autocast: median {ms:.2f} ms ({out['spread'][0]:.2f}-"
        f"{out['spread'][1]:.2f}) over {reps} steps, {out['tok_s']:.0f} tokens/s, peak memory "
        f"{peak:.2f} GiB ({peak - held:.2f} above the {held:.2f} held before), busy share {out['busy']:.3f} (3 steps: {busy:.1f} ms of {wall:.1f} "
        f"ms, {n} launches), launches over the {reps} steps {launches or 'none'}, losses "
        f"finite {out['finite']} | card {card}")
    del state
    torch.cuda.empty_cache()
    return out


def _flash_vs_sdpa(sd, batch) -> dict:
    """One GPT loss and its gradients through the flash route and through
    the SDPA route on the card (bf16 autocast, dropout off so that the two
    draw nothing), held to TRAIN_TOL; → the flash route's launches."""
    from ttts_tpu_torch.train.steps import autocast, gpt_loss

    out = {}
    for name, flash in (("flash", True), ("sdpa", False)):
        model = _flash_models(flash, 0.0, sd)
        reset_counts()
        with autocast(torch.device("cuda"), torch.bfloat16):
            loss, _, _ = gpt_loss(model, batch)
        grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
        torch.cuda.synchronize()
        out[name] = (loss.item(), [g.float().cpu() if g is not None else None for g in grads],
                     counts())
        names = [n for n, _ in model.named_parameters()]
        del model, loss, grads
        torch.cuda.empty_cache()
    named = [n for n in names if n.startswith("gpt.h.") and ".attn.c_" in n and n.endswith("weight")]
    _hold_train("GPT step", out["flash"][0], out["sdpa"][0],
                _grad_reading(names, out["flash"][1], out["sdpa"][1]), named, tag="(p)",
                against="flash route vs SDPA route, both on the card")
    return out["flash"][2]


def _flash_repeat(sd, batch) -> None:
    """The same gpt_train_step (dropout on, one key) on two fresh states
    under deterministic algorithms: metrics and parameters bit-equal."""
    from ttts_tpu_torch.train.steps import gpt_train_step

    det = (torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs = []
        for _ in range(2):
            state = _flash_state(True, sd)
            m = gpt_train_step(state, batch, 7, amp_dtype=torch.bfloat16)
            runs.append(({k: float(v) for k, v in m.items()},
                         [p.detach().clone() for p in state.params]))
            del state
    finally:
        torch.backends.cudnn.deterministic = det[0]
        torch.use_deterministic_algorithms(det[1])
    same = runs[0][0] == runs[1][0] and all(torch.equal(a, b) for a, b in zip(runs[0][1],
                                                                               runs[1][1]))
    log(f"(p) the flash-route step twice under deterministic algorithms (dropout 0.1, key 7): "
        f"metrics {runs[0][0]} and {runs[1][0]}, parameters bit-equal {same}")
    if not same:
        raise AssertionError("(p) the flash-route step does not repeat bit for bit")


def _flash_cli(root, card: str) -> dict:
    """`python -m ttts_tpu_torch.train.mains gpt --config <flash, attention
    dropout 0, checkpointing> ...` in this process (its launches counted),
    FLASH_CLI_STEPS steps of batch 32 on phase (k)'s synthetic rows: each
    step's forward launches the forward kernel twice a layer (the block
    recomputed by the checkpoint in the backward), its backward the dQ and
    the dK/dV kernels once a layer."""
    from ttts_tpu_torch.train import mains
    from ttts_tpu_torch.train.checkpoints import trained_state_dict

    manifest = _train_data(root)
    cfg = root / "flash.json"
    cfg.write_text(json.dumps({
        "gpt": {"flash_attention": True, "attn_dropout": 0.0, "checkpointing": True},
        "train": {"train_steps": FLASH_CLI_STEPS, "save_freq": FLASH_CLI_STEPS,
                  "batch_size": TRAIN_BATCH}}))
    reset_counts()
    t0 = time.perf_counter()
    mains.main(["gpt", "--config", str(cfg), "--manifest", manifest, "--logs",
                str(root / "gpt_flash")])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {n: c for n, c in counts().items() if c}
    want = {n: FLASH_CLI_STEPS * c * (2 if n == "flash_causal_lse" else 1)
            for n, c in FLASH_STEP_LAUNCHES.items()}
    sd = trained_state_dict("gpt", root / "gpt_flash")[0]
    finite = all(bool(torch.isfinite(v).all()) for v in sd.values() if v.is_floating_point())
    log(f"(p) train.mains gpt --config {{gpt: flash_attention, attn_dropout 0, checkpointing; "
        f"{FLASH_CLI_STEPS} steps of batch {TRAIN_BATCH}}}: {secs:.1f} s, launches {launches} "
        f"(expected {want}), checkpoint at step {FLASH_CLI_STEPS} finite {finite} | card {card}")
    if launches != want or not finite:
        raise AssertionError("(p) the gpt CLI's flash route launched otherwise or diverged")
    return launches



def phase_flash_train(card: str, rows: list) -> dict:
    """(p) The GPT's long-context training route on the card: the kernels
    against their plain versions and timed at the reference context; one
    step through the flash and the SDPA routes (loss, gradients); steps
    timed in turns (flash, SDPA, SDPA, flash); a step repeated bit for bit;
    the gpt CLI with a flash config. → the launches for the kernel table."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    g = torch.Generator("cuda").manual_seed(14)
    _check_flash_kernels(rows, g)
    batch = _flash_batch(FLASH_CTX[0])
    sd = {k: v.cpu() for k, v in _flash_models(True, 0.1).state_dict().items()}
    torch.cuda.empty_cache()
    per_loss = _flash_vs_sdpa(sd, batch)
    want = {n: FLASH_STEP_LAUNCHES.get(n, 0) for n in KERNELS}
    if per_loss != want:
        raise AssertionError(f"(p) a flash-route loss and its gradients launched {per_loss}, "
                             f"expected {want}")
    runs = [_flash_steps(flash, sd, batch, card) for flash in (True, False, False, True)]
    for run, flash in zip(runs, (True, False, False, True)):
        exp = {n: c * run["reps"] for n, c in FLASH_STEP_LAUNCHES.items()} if flash else {}
        if run["launches"] != exp or not run["finite"]:
            raise AssertionError(f"(p) steps launched {run['launches']}, expected {exp}")
    _flash_repeat(sd, batch)
    root = pathlib.Path(tempfile.mkdtemp(prefix="ttts_flash_"))
    try:
        cli = _flash_cli(root, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"(p) phase (p) {time.perf_counter() - t_phase:.1f} s | card {card}")
    return {"launches": runs[0]["launches"], "reps": runs[0]["reps"], "cli": cli}


# ---------------------------------------------------------------------- (q)

# The grouped experts against their plain per-expert loop (moe_experts_plain:
# f32 products of the same bf16 inputs, h rounded to bf16 between them):
#   rel_l2 <= MOE_TOL, as tests/test_torch_moe_card.py: bf16 inputs and h,
#   f32 sums in another order; h rounds to bf16 on both sides, and a
#   last-bit difference there moves y by ~2^-9 of that term: correct
#   1.5e-4 on an H100. The library yardsticks round h and the down product's
#   output to bf16 (~4e-3); MOE_LIB_TOL only shows that they compute the
#   same function.
MOE_TOL, MOE_LIB_TOL = 5e-3, 2e-2
MOE_E, MOE_D, MOE_F, MOE_K = 64, 2048, 1408, 6
MOE_SHAPES = (("decode", 64), ("prefill", 6400), ("latent", 4640))  # token rows
MOE_SRC = "ttts_tpu_torch/csrc/moe_experts.cu"


def _moe_inputs(g, rows: int):
    """Rows, their MOE_K distinct experts from random scores and weights,
    sorted as the trunk sorts them: (xs, counts, ws, x, idx, w, dest)."""
    from ttts_tpu_torch.models import mla_moe

    x = torch.randn(rows, MOE_D, generator=g, device="cuda").bfloat16()
    idx = torch.rand(rows, MOE_E, generator=g, device="cuda").topk(MOE_K, dim=-1).indices
    w = torch.rand(rows, MOE_K, generator=g, device="cuda")
    dest, counts, token = mla_moe.group_pairs(idx, MOE_E)
    ws = torch.empty(rows * MOE_K, device="cuda").index_copy_(0, dest, w.reshape(-1))
    return x.index_select(0, token), counts, ws, x, idx, w, dest


def _moe_bf16_loop(xs, sizes, gate_up, down, ws):
    """The experts as bf16 cuBLAS products, gate/up then down, an expert at
    a time, the group sizes given on the host (no read of the counts: a
    lower bound of such a loop)."""
    y = torch.empty(xs.shape, dtype=torch.float32, device=xs.device)
    at = 0
    for e, n in enumerate(sizes):
        if n:
            g, u = (xs[at: at + n] @ gate_up[e].t()).chunk(2, dim=-1)
            y[at: at + n] = ((torch.nn.functional.silu(g) * u) @ down[e].t()).float() * \
                ws[at: at + n, None]
        at += n
    return y


def _moe_grouped_mm(xs, counts, gate_up, down, ws):
    """The experts as two torch._grouped_mm calls (CUTLASS grouped GEMMs,
    the group ends read on the device), h in bf16 between them."""
    offs = counts.cumsum(0, dtype=torch.int32)
    gu = torch._grouped_mm(xs, gate_up.transpose(1, 2), offs=offs)
    g, u = gu.chunk(2, dim=-1)
    h = torch.nn.functional.silu(g) * u
    return torch._grouped_mm(h, down.transpose(1, 2), offs=offs).float() * ws[:, None]


def _moe_every_expert(x, idx, w, gate_up, down):
    """Every expert over every row in two batched products, each row's own
    experts kept: (E, N, 2F) then (E, N, D), masked and summed → each
    row's combined output (N, D), not each pair's."""
    gu = torch.einsum("nd,efd->enf", x, gate_up)
    h = torch.nn.functional.silu(gu[..., :MOE_F]) * gu[..., MOE_F:]
    y = torch.einsum("enf,edf->end", h, down).float()
    mask = torch.zeros(MOE_E, x.shape[0], device=x.device)
    mask.scatter_add_(0, idx.t(), w.t())
    return (y * mask[..., None]).sum(0)


def _moe_kernel_rows(g) -> list:
    """The kernel at each MOE_SHAPES pair count against the plain loop, and
    its times beside the bound and the yardsticks."""
    from portbench.roofline.moe_experts import work
    from ttts_tpu_torch.ops.cuda import moe

    gate_up = (torch.randn(MOE_E, 2 * MOE_F, MOE_D, generator=g, device="cuda")
               / MOE_D ** 0.5).bfloat16()
    down = (torch.randn(MOE_E, MOE_D, MOE_F, generator=g, device="cuda")
            / MOE_F ** 0.5).bfloat16()
    out = []
    for what, rows in MOE_SHAPES:
        xs, counts, ws, x, idx, w, dest = _moe_inputs(g, rows)
        sizes, read = counts.tolist(), int((counts > 0).sum())
        args = (xs, counts, gate_up, down, ws)
        want = moe.moe_experts_plain(*args)
        m = compare(moe.moe_experts(*args), want)
        runs = {"kernel": lambda: moe.moe_experts(*args),
                "plain": lambda: moe.moe_experts_plain(*args),
                "bf16_loop": lambda: _moe_bf16_loop(xs, sizes, gate_up, down, ws),
                "grouped_mm": lambda: _moe_grouped_mm(*args)}
        if rows <= 64:
            runs["every_expert"] = lambda: _moe_every_expert(x, idx, w, gate_up, down)
        lib_err, ms = {}, {}
        for name, fn in runs.items():
            try:
                got = fn()
            except (RuntimeError, AttributeError, NotImplementedError) as exc:
                if name != "grouped_mm":
                    raise
                ms[name], lib_err[name] = None, f"not available: {str(exc)[:120]}"
                continue
            if name not in ("kernel", "plain"):
                ref = want if name != "every_expert" else \
                    want.index_select(0, dest).view(rows, MOE_K, -1).sum(1)
                lib_err[name] = float((got - ref).norm() / ref.norm())
                if not lib_err[name] <= MOE_LIB_TOL:
                    raise AssertionError(f"(q) {name} at {what}: rel_l2 {lib_err[name]:.3e} "
                                         f"> {MOE_LIB_TOL}")
            ms[name] = median_ms(fn, reps=5 if name == "plain" else 20)
        wk = work(rows * MOE_K, read, MOE_D, MOE_F)
        bms, by = bound(wk["flop"], wk["bytes"])
        shape = f"{rows * MOE_K} pairs over {read} experts ({what})"
        log(f"(q) moe_experts {shape}: rel_l2 {m['rel_l2']:.3e} (tol {MOE_TOL}) | kernel "
            f"{ms['kernel']:.4f} ms, plain loop {ms['plain']:.4f} ms, "
            + ", ".join(f"{k} " + (f"{v:.4f} ms (rel_l2 {lib_err[k]:.1e})" if v is not None
                                   else lib_err[k]) for k, v in ms.items()
                        if k not in ("kernel", "plain"))
            + f" | bound {bms:.4f} ms ({by}), {100 * bms / ms['kernel']:.1f}% of it")
        if not m["rel_l2"] <= MOE_TOL:
            raise AssertionError(f"(q) moe_experts at {what}: rel_l2 {m['rel_l2']:.3e} > "
                                 f"{MOE_TOL}")
        out.append({"name": f"moe_experts_{what}", "shape": shape,
                    "max_abs_err": m["max_abs"], "rel_l2": m["rel_l2"], "ms": ms["kernel"],
                    "plain_ms": ms["plain"], "library_ms": ms["bf16_loop"],
                    "grouped_mm_ms": ms["grouped_mm"],
                    "every_expert_ms": ms.get("every_expert"), "bound_ms": bms,
                    "bound_by": by})
        del args, want, xs, x
    return out


def _moe_call_ms(model, args, reps: int = 5) -> float:
    from ttts_tpu_torch.models import gpt

    return median_ms(lambda: gpt.inference_speech(model, *args), reps=reps, warmup=1)


def _moe_trunk(g) -> dict:
    """A 3-layer trunk at the published widths through inference_speech on
    64 rows: launches and counters of a replayed call, and a steady call
    with and without the route capture."""
    from portbench.traffic.serve_batch_lm import RouteCapture
    from ttts_tpu_torch.config import MLAMoEConfig, default_config
    from ttts_tpu_torch.models import gpt, mla_moe
    from ttts_tpu_torch.models.sampling import SamplingParams
    from ttts_tpu_torch.ops.cuda import moe

    lm = dataclasses.replace(MLAMoEConfig(), num_hidden_layers=3)
    cfg = dataclasses.replace(default_config().gpt, model_dim=lm.hidden_size,
                              heads=lm.num_attention_heads, layers=3)
    with torch.device("meta"):
        model = gpt.UnifiedVoice(cfg, trunk=lm)
    mla_moe.materialize(model, torch.device("cuda"), torch.bfloat16, 0)
    model.eval().requires_grad_(False)
    routed = sum(b.routed for b in model.gpt.h)
    rows, steps, v = 64, 64, cfg.number_mel_codes
    text = torch.randint(1, 255, (rows, 32), generator=g, device="cuda")
    prompt = torch.randint(0, 1024, (rows, 48), generator=g, device="cuda")
    gumbel = -torch.log(-torch.log(torch.rand(steps, rows, v, generator=g, device="cuda")))
    sampling = SamplingParams(top_p=0.8, temperature=0.8, repetition_penalty=2.0)
    args = (text, prompt, steps, sampling, gumbel)
    prefix = text.shape[1] + 2 + prompt.shape[1] + 1
    with torch.no_grad():
        gpt.inference_speech(model, *args)  # captures
        moe.moe_experts.launches = 0
        graphs, seen = dict(gpt.inference_speech.graphs), moe.counters()
        codes = gpt.inference_speech(model, *args)
        torch.cuda.synchronize()
        now = moe.counters()
        passes = {k: gpt.inference_speech.graphs[k] - graphs[k] for k in graphs}
        launches = moe.moe_experts.launches
        want = routed * (1 + passes["replayed_steps"] + passes["eager_steps"])
        pairs = now["moe.pairs"] - seen["moe.pairs"]
        want_pairs = routed * MOE_K * rows * (prefix + steps)
        if (passes["captures"], passes["eager_steps"], launches, pairs) != (
                0, 0, want, want_pairs) or not codes.shape == (rows, steps):
            raise AssertionError(
                f"(q) a replayed trunk call: passes {passes}, moe_experts launches "
                f"{launches} (want {want}), pairs {pairs} (want {want_pairs})")
        read = (now["moe.experts_read"] - seen["moe.experts_read"]) / launches
        bare = _moe_call_ms(model, args)
        log_ = RouteCapture(model)
        model.decode_graph = None  # capture the step with the hooks' writes
        hooked = _moe_call_ms(model, args)
        last = log_.decode[1][:, prefix + steps - 1].tolist()
        log_.remove()
        model.decode_graph = None
        bare2 = _moe_call_ms(model, args)
    if not all(len(set(r)) == MOE_K for r in last):
        raise AssertionError("(q) the route capture left the last decode step's row unwritten")
    per = (hooked - (bare + bare2) / 2) / (routed * steps) * 1e3
    log(f"(q) 3-layer trunk ({routed} routed), {rows} rows, prefix {prefix}, {steps} steps: "
        f"moe_experts launches {launches} = {routed} routed x (1 prefill + "
        f"{passes['replayed_steps']} replayed steps), pairs {pairs}, {read:.1f} experts read a "
        f"launch | a call {bare:.2f} / {bare2:.2f} ms, with the route capture {hooked:.2f} ms: "
        f"{per:.2f} us a routed layer a step (x 26 x 256 in the cell's call: "
        f"{per * 26 * 256 / 1e3:.2f} ms)")
    del model
    return {"launches": launches, "route_capture_us": per}


def phase_moe(card: str) -> dict:
    """(q) The grouped expert kernel at the MLA-MoE cell's shapes and in a
    trunk's decode → its kernel-table rows."""
    t_phase = time.perf_counter()
    g = torch.Generator("cuda").manual_seed(20)
    rows = _moe_kernel_rows(g)
    torch.cuda.empty_cache()
    trunk = _moe_trunk(g)
    torch.cuda.empty_cache()
    table = [{"name": r["name"], "route": "cuda", "source": MOE_SRC, "replaces": None,
              "launches_trunk_call": trunk["launches"], **{k: r[k] for k in r if k != "name"}}
             for r in rows]
    log(f"(q) phase (q) {time.perf_counter() - t_phase:.1f} s | card {card}")
    return {"table": table, "route_capture_us": trunk["route_capture_us"]}


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
    train, trained = phase_training(card, rows)
    keep = pathlib.Path(tempfile.mkdtemp(prefix="ttts_codec_"))
    try:
        gan = phase_gan(card, rows, keep)
        del tts
        torch.cuda.empty_cache()
        recipe = phase_recipe(card, rows, trained, keep)
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    torch.cuda.empty_cache()
    library = phase_library(card, rows)
    torch.cuda.empty_cache()
    multi = phase_multigpu(card, rows)
    torch.cuda.empty_cache()
    flash = phase_flash_train(card, rows)
    torch.cuda.empty_cache()
    moe_rows = phase_moe(card)["table"]
    table = []
    for name, (_, _, _, source, replaces) in KERNELS.items():
        mine = [r for r in rows if r["name"] == name]
        last = mine[-1]  # the last shape measured: the path's largest
        # the training route's kernels: launches of phase (p)'s timed flash
        # steps at the reference context, and of the gpt CLI's run
        route = {"launches_gpt_flash_train_step": flash["launches"][name] / flash["reps"],
                 "launches_gpt_flash_cli": flash["cli"][name]} if name in TRAIN_ONLY else {}
        table.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                      "launches": flash["launches"][name] if route else launches[name], **route,
                      "launches_per_fast_call": per_fast[name],
                      "launches_codec_infer": codec[name],
                      "launches_unipc_fast_call": slice7[name],
                      "launches_gpt_train_step": train["gpt"][name],
                      "launches_diffusion_train_step": train["diffusion"][name],
                      "launches_vqvae_train_step": gan["per_step"][name],
                      "launches_pipeline_vq_per_clip": recipe["vq_per_clip"][name],
                      "launches_clvp_train_step": recipe["clvp"][name],
                      "launches_classifier_train_step": recipe["classifier"][name],
                      "launches_diffusion_eval_hook": recipe["eval_hook"][name],
                      "max_abs_err": max(r["max_abs_err"] for r in mine),
                      "ms": last["ms"], "plain_ms": last["plain_ms"],
                      "bound_ms": last["bound_ms"], "bound_by": last["bound_by"],
                      "library_ms": last["library_ms"]})
    # kernels at a training path's shapes: rows of their own, whose launches
    # are that path's (the VQ kernel in the GAN run, the trunk and causal
    # kernels in the diffusion eval hook's call, at its largest shape)
    extra = [("vq_nearest_gan_train", "vq_nearest", gan["launches"],
              {"launches_vqvae_train_step": gan["per_step"]["vq_nearest"]})]
    extra += [(f"{n}_eval_hook", n, recipe["eval_hook"][n], {}) for n in HELD]
    extra += [(f"vq_nearest_{m}", "vq_nearest", library[m]["launches"],
               {"launches_per_call": library[m]["per_call"]}) for m in ("rvq1", "dvae")]
    # the decode kernel's launches on tensor-parallel shards' caches, counted
    # in phase (o) (one card runs no tp > 1 serving call)
    extra += [(f"decode_attention_tp{tp}", "decode_attention", multi["tp_shards"][tp], {})
              for tp in (2, 4)]
    for row_name, name, n_launches, more in extra:
        row = [r for r in rows if r["name"] == row_name][-1]
        _, _, _, source, replaces = KERNELS[name]
        table.append({"name": row_name, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": n_launches, **more,
                      "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                      "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                      "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    table += moe_rows  # the MLA-MoE trunk's experts: no TPU kernel, launches of (q)'s call
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
