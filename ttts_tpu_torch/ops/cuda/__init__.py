"""Hand-written Hopper kernels and their plain PyTorch versions.

One module per Pallas file of ttts_tpu/ops/pallas. Each wrapper dispatches on
the device of its input alone: a CPU tensor takes the plain version, a CUDA
tensor launches the kernel (built from ttts_tpu_torch/csrc by `_build`) or
raises, as it does on an input that autograd would record (the kernels have
no backward: the dispatches beside the wrappers take the plain versions
then, `_build.records_grad`). Each wrapper counts its kernel launches in
its `launches` attribute (flash_attention: a dict of counts per mode).
"""
