"""Hand-written Hopper kernels and their plain PyTorch versions.

One module per Pallas file of ttts_tpu/ops/pallas; attention.py also holds
the GPT's training route (attention.FlashCausal), the port of the library
flash kernel that ttts_tpu/models/gpt.py calls, with its forward and
backward kernels.
Each wrapper dispatches on the device of its input alone: a CPU tensor
takes the plain version, a CUDA tensor launches the kernel (built from
ttts_tpu_torch/csrc by `_build`) or raises, as it does on an input that
autograd would record (a wrapper records no graph: the dispatches beside
the wrappers take the plain versions then, `_build.records_grad`, and
FlashCausal calls its wrappers with grad mode off). Each wrapper counts its
kernel launches in its `launches` attribute (flash_attention: a dict of
counts per mode, the training route's "causal_lse" and "causal_bwd"
included; "causal_bwd" counts two a call, its dQ and dK/dV kernels).
"""
