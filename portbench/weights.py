"""Seeded weights for both sides of a cell: the same values from the same
seed and state-dict keys, made on the device in one draw per module.

The rule is the benchmark's own, by key and shape, and takes nothing from
the program's initialisers: a matrix or a convolution N(0, 1/fan_in)
(an embedding table N(0, 0.02^2)), a bias or a LayerNorm beta N(0, 0.02^2),
any other vector (a norm's scale, a layer scale, a log-scale activation
parameter) 1 + N(0, 0.1^2); a VQ codebook N(0, 1), with its EMA copy,
unit cluster sizes and its `inited` flag set. Attention output projections,
zero at initialisation in the published models, get the matrix rule, so a
wrong attention cannot hide behind a zero projection.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

Shapes = Iterable[Tuple[str, Tuple[int, ...]]]


def module_seed(seed: int, module: str) -> int:
    """A 63-bit seed for one module's draw, from the run's seed and its name."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF] + list(module.encode())
    return int(np.random.SeedSequence(words).generate_state(2, np.uint32).astype(np.uint64)
               .view(np.uint64)[0] >> np.uint64(1))


def _scaled(name: str, shape: Tuple[int, ...], z: torch.Tensor) -> torch.Tensor:
    leaf = name.rsplit(".", 1)[-1]
    if name.endswith("._codebook.embed"):
        return z
    if len(shape) >= 2:
        if "emb" in name.lower() and len(shape) == 2 and "_layers" not in name:
            return z * 0.02
        if len(shape) == 2:  # (in, out) or (out, in): the smaller side is fan-in
            fan_in = min(shape)
        else:  # convolutions: (out, in, taps)
            fan_in = math.prod(shape[1:])
        return z / math.sqrt(max(fan_in, 1))
    if leaf in ("bias", "beta"):
        return z * 0.02
    return 1.0 + 0.1 * z


def make_state(shapes: Shapes, seed: int, module: str, device) -> Dict[str, torch.Tensor]:
    """{key: f32 tensor} for the (key, shape) pairs, keys taken in sorted
    order, from one torch.Generator on `device` seeded by (seed, module)."""
    items = sorted((k, tuple(s)) for k, s in shapes)
    total = sum(math.prod(s) for _, s in items)
    g = torch.Generator(device=device).manual_seed(module_seed(seed, module))
    flat = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for key, shape in items:
        n = math.prod(shape)
        z = flat[at: at + n].view(shape)
        at += n
        out[key] = _scaled(key, shape, z)
    codebooks = [k for k in out if k.endswith("._codebook.embed")]
    for key in codebooks:
        stem = key[: -len("embed")]
        if stem + "embed_avg" in out:
            out[stem + "embed_avg"] = out[key].clone()
        if stem + "cluster_size" in out:
            out[stem + "cluster_size"] = torch.ones_like(out[stem + "cluster_size"])
        if stem + "inited" in out:
            out[stem + "inited"] = torch.ones_like(out[stem + "inited"])
    return out


def shapes_of(module: torch.nn.Module) -> Shapes:
    """(key, shape) of every floating-point state-dict entry."""
    return [(k, tuple(v.shape)) for k, v in module.state_dict().items()
            if v.is_floating_point()]


def hold_stop_code(state: Dict[str, torch.Tensor], stop: int, head: str = "mel_head") -> None:
    """Hold the GPT's stop code down: its head row 0 and its bias -1e4, so
    no draw and no greedy choice ever takes it and every stream runs to the
    call's max_generate_length."""
    state[f"{head}.weight"][stop] = 0.0
    state[f"{head}.bias"][stop] = -1.0e4
