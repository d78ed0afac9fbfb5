"""The control of the correctness check: the plain reference computed one
precision below the configuration's bf16, in fp8 (e4m3, one scale per
tensor from its largest magnitude): every matrix and convolution weight and
every floating input of the module that holds it is rounded to fp8 before
the product. The rounding passes gradients straight through, so the same
lowering serves a training step.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.utils.parametrize as parametrize

E4M3_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale, in x's dtype."""
    amax = x.detach().abs().max().float().clamp_min(1e-30)
    scale = E4M3_MAX / amax
    return ((x.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(x.dtype)


def straight_through(x: torch.Tensor) -> torch.Tensor:
    return x + (fp8(x) - x).detach()


class _Round(nn.Module):
    def forward(self, w):
        return straight_through(w)


def _round_inputs(module, args):
    return tuple(straight_through(a) if isinstance(a, torch.Tensor) and a.is_floating_point()
                 else a for a in args)


def lower(model: nn.Module) -> nn.Module:
    """`model` with every module that holds a weight of two or more
    dimensions computing on fp8-rounded weights and inputs (in place)."""
    for m in list(model.modules()):
        w = getattr(m, "weight", None)
        if isinstance(w, nn.Parameter) and w.ndim >= 2:
            parametrize.register_parametrization(m, "weight", _Round(), unsafe=True)
            m.register_forward_pre_hook(_round_inputs)
    return model
