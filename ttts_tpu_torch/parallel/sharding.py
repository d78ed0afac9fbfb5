"""Parameter sharding rules for tensor parallelism over the `model` axis,
port of ttts_tpu/parallel/sharding.py as torch.distributed.tensor
placements.

The JAX rule shards the output dimension (flax's last axis) of every 2-D+
weight with at least `min_size` elements over `model` when the axis size
divides it, and replicates the rest. A torch state dict keeps some weights
in other layouts (porting.py): nn.Linear is (out, in) and the convolutions
(torch's, blocks.Conv1d, the 1x1 convolutions) are (out, in, k), so their
output dimension is 0; nn.ConvTranspose1d is (in, out, k), dimension 1;
the GPT-2 Conv1D (in, out), nn.Embedding (num, dim) and bare parameters
keep flax's layout, the last dimension. A sharded module computes through
DTensor's sharding propagation: run it under
`torch.distributed.tensor.experimental.implicit_replication()`, so that
plain tensors count as replicated.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn as nn

from ttts_tpu_torch.parallel.mesh import axis_size

# the classes whose weights are (out, in[, k]): torch's and the port's own
_OUT_FIRST = {"Linear", "Conv1d", "Conv2d", "Conv1x1"}


def output_dim(module: nn.Module, param: torch.Tensor) -> int:
    """The output dimension of `param`, a parameter of `module`."""
    if isinstance(module, nn.ConvTranspose1d):
        return 1
    if isinstance(module, nn.Linear) or type(module).__name__ in _OUT_FIRST:
        return 0
    return param.ndim - 1


def infer_param_shardings(model: nn.Module, mesh, min_size: int = 8192
                          ) -> Dict[str, List]:
    """{parameter name: placements on mesh["model"]}: [Shard(d)] of the
    output dimension d of large 2-D+ weights when the model axis divides it,
    else [Replicate()]."""
    from torch.distributed.tensor import Replicate, Shard

    n = axis_size(mesh, "model")
    out = {}
    for name, p in model.named_parameters():
        owner = model.get_submodule(name.rpartition(".")[0])
        d = output_dim(owner, p)
        if n > 1 and p.ndim >= 2 and p.numel() >= min_size and p.shape[d] % n == 0:
            out[name] = [Shard(d)]
        else:
            out[name] = [Replicate()]
    return out


def shard_params(model: nn.Module, mesh, min_size: int = 8192) -> nn.Module:
    """Replace `model`'s parameters in place by DTensors on mesh["model"]
    with infer_param_shardings' placements. → model."""
    from torch.distributed.tensor import distribute_tensor

    sub = mesh["model"]
    for name, placements in infer_param_shardings(model, mesh, min_size).items():
        owner_name, _, attr = name.rpartition(".")
        owner = model.get_submodule(owner_name)
        p = getattr(owner, attr)
        setattr(owner, attr, nn.Parameter(distribute_tensor(p.data, sub, placements),
                                          requires_grad=p.requires_grad))
    return model
