"""ttts_tpu_torch — the PyTorch / CUDA port of ttts_tpu for NVIDIA Hopper.

The JAX package ttts_tpu is the reference; this package mirrors its layout
and parameter semantics, imports no JAX, and replaces each Pallas TPU kernel
on its path with a hand-written CUDA kernel (ops/cuda, sources in csrc/).

Layout:
  ops/        resample, STFT, mel (plain PyTorch) and ops/cuda (the kernels)
  models/     codec extract path, GPT, CLVP, diffusion net, Vocos (nn.Modules)
  diffusion/  DPM-Solver++(2M) with batched classifier-free guidance
  text/       pinyin and BPE frontend (its vocabulary in assets/)
  config.py   the configuration dataclasses
  api.py      TextToSpeech: the zero-shot serving path
  porting.py  ttts_tpu params → this package's state dicts

It keeps its own copies of the JAX package's config and text modules and
imports nothing of ttts_tpu.
"""

__version__ = "0.1.0"
