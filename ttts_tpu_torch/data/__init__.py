"""Audio file input and output (the port's copy of ttts_tpu/data's stdlib path)."""
