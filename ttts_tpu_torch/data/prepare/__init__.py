"""Offline data preparation (ttts_tpu_torch.data.prepare.pipeline and .misc)."""
