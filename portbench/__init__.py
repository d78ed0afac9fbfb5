"""The benchmark of the PyTorch and CUDA port (ttts_tpu_torch); see run.py."""
