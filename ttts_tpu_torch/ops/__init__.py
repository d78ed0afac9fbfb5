"""DSP primitives (resample, STFT, mel) and the CUDA kernels (ops.cuda)."""
