"""ttts_tpu_torch — the PyTorch / CUDA port of ttts_tpu for NVIDIA Hopper.

The JAX package ttts_tpu is the reference; this package mirrors its layout
and parameter semantics, imports no JAX, and replaces each Pallas TPU kernel
on its path with a hand-written CUDA kernel (ops/cuda, sources in csrc/).

Layout:
  ops/        resample, STFT, mel (plain PyTorch) and ops/cuda (the kernels)
  models/     codec extract path, GPT, diffusion net, Vocos (nn.Modules)
  diffusion/  DPM-Solver++(2M) with batched classifier-free guidance
  api.py      TextToSpeech: the zero-shot serving path
  porting.py  ttts_tpu params → this package's state dicts

It reuses the JAX-free ttts_tpu.config and ttts_tpu.text modules.
"""

__version__ = "0.1.0"
