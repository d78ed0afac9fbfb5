"""The plain reference: the port's model code frozen here in plain PyTorch,
its kernel dispatch replaced by the kernels' plain versions (plain.py), run
in f32. It imports nothing of the program (ttts_tpu_torch) and nothing of
the JAX package."""
