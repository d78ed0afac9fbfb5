"""Model FLOPs of one serving call and of one GPT training step, the
benchmark's own count for the `mfu` metrics.

The GPT is counted by formula: its matrix products (12 d^2 a layer and
token, 2 flop a multiply-add) plus causal attention (4 d a causal pair and
layer), the mel head where logits are made. The CLVP, the diffusion
conditioning and trunk and Vocos are counted by torch's FlopCounterMode
over the plain reference modules under a FakeTensorMode (no memory, no
arithmetic) at the call's shapes: every product and convolution, attention
over all T x T pairs, as those models compute it.
"""

from __future__ import annotations

import functools
import json
import warnings

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.check import ref_config


def gpt_matmul_params(d: int, layers: int) -> int:
    return 12 * d * d * layers


def gpt_forward(rows: int, t: int, d: int, layers: int) -> float:
    """A causal forward over `rows` sequences of `t` tokens, without heads."""
    return rows * (2.0 * gpt_matmul_params(d, layers) * t + 4.0 * d * layers * t * (t + 1) / 2)


def gpt_train_step(rows: int, text_pad: int, mel_pad: int, d: int, layers: int,
                   text_vocab: int, mel_vocab: int) -> float:
    """Forward and backward (3x the forward's products; causal attention's
    backward 2.5x its forward) of one GPT training step on `rows` rows of
    [start; text; stop] ++ [start; mel; stop] of text_pad text and mel_pad
    mel tokens, both heads included."""
    tt, tm = text_pad + 2, mel_pad + 2
    t = tt + tm
    products = 2.0 * rows * (gpt_matmul_params(d, layers) * t + d * (text_vocab * tt
                                                                      + mel_vocab * tm))
    attention = rows * 4.0 * d * layers * t * (t + 1) / 2
    return 3.0 * products + 3.5 * attention


def serve_call(cfg_file: dict, n: int, k: int, lt: int, lp: int, max_gen: int, bucket: int,
               steps: int, t_ref: int) -> dict:
    """{stage: flop} of one `tts_batch` call of `n` texts padded to `lt`
    tokens, `k` candidates, a prompt of `lp` codes, `max_gen` decode steps,
    a tail bucket of `bucket` codes, `steps` sampler steps and a reference
    mel of `t_ref` frames."""
    c = ref_config(cfg_file)
    g = c.gpt
    d, layers, vocab = g.model_dim, g.layers, g.number_mel_codes
    rows = n * k
    p = lt + 2 + lp + 1
    out = {"gpt_prefill": gpt_forward(rows, p, d, layers) + 2.0 * rows * d * vocab,
           "gpt_decode": rows * sum(2.0 * gpt_matmul_params(d, layers)
                                    + 4.0 * d * layers * (p + i + 1) + 2.0 * d * vocab
                                    for i in range(max_gen)),
           "gpt_latent": gpt_forward(n, lt + 2 + bucket + 2, d, layers)}
    key = json.dumps(cfg_file, sort_keys=True)
    if k > 1:
        out["clvp_rerank"] = _counted_module(key, "clvp", (rows, lt, max_gen))
    out["conditioning"] = _counted_module(key, "conditioning", (n, bucket, t_ref))
    out["diffusion"] = steps * _counted_module(key, "trunk", (2 * n, 4 * bucket))
    out["vocos"] = _counted_module(key, "vocos", (n, 4 * bucket))
    return out


@functools.lru_cache(maxsize=64)
def _counted_module(cfg_json: str, part: str, shape: tuple) -> float:
    """The FLOPs of one reference module call at `shape`, counted on fake
    tensors (cached by shape)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from portbench.reference import clvp, diffusion_net, vocos

    c = ref_config(json.loads(cfg_json))
    z = torch.zeros
    with warnings.catch_warnings(), FakeTensorMode(allow_non_fake_inputs=True):
        warnings.simplefilter("ignore")
        if part == "clvp":
            rows, lt, codes = shape
            m = clvp.CLVP(c.clvp)
            args = (z(rows, lt, dtype=torch.long), z(rows, codes, dtype=torch.long))
            fn = m
        elif part in ("conditioning", "trunk"):
            m = diffusion_net.AA_diffusion(c.diffusion_net)
            dn = c.diffusion_net
            if part == "conditioning":
                n, bucket, t_ref = shape
                fn = m.timestep_independent
                args = (z(n, bucket, dn.in_latent_channels), z(n, t_ref, dn.in_channels),
                        4 * bucket)
            else:
                rows, t = shape
                fn = m.trunk
                args = (z(rows, t, dn.in_channels), z(rows), z(rows, t, dn.model_channels))
        else:
            n, t = shape
            m = vocos.Vocos(c.vocos)
            fn, args = m, (z(n, t, c.vocos.input_channels),)
        m.eval().requires_grad_(False)
        with FlopCounterMode(display=False) as counter, torch.no_grad():
            fn(*args)
    return float(counter.get_total_flops())
