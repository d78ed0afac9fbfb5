"""Model FLOPs of one serving call whose speech LM has the MLA-MoE trunk
(a configuration with a published deepseek_v3 config.json's keys at its
top level), the benchmark's own count for `serve.moe.mfu`.

The trunk by formula, 2 flop a multiply-add, each token through the
parameters it uses: attention's four projections, layer 0's dense SwiGLU,
each routed layer's router, its k chosen experts and its shared experts.
Causal attention in the full form (prefill, latent) costs h (nope + rope +
v) multiply-adds a causal pair and layer; a decode step runs the absorbed
form, whose two absorbed products cost what kv_b_proj would, and h (2 lat
+ rope) a cached position. The mel head where logits are made. The CLVP,
the diffusion conditioning and trunk and Vocos as portbench/flops.py
counts them.
"""

from __future__ import annotations

from portbench import flops


def attention_params(c: dict) -> int:
    h, nope, rope, v, lat = (c["num_attention_heads"], c["qk_nope_head_dim"],
                             c["qk_rope_head_dim"], c["v_head_dim"], c["kv_lora_rank"])
    d = c["hidden_size"]
    return d * h * (nope + rope) + d * (lat + rope) + lat * h * (nope + v) + h * v * d


def ffn_params(c: dict, layer: int) -> int:
    """The FFN parameters one token uses in `layer`."""
    d = c["hidden_size"]
    if layer < c["first_k_dense_replace"]:
        return 3 * d * c["intermediate_size"]
    f = c["moe_intermediate_size"]
    return d * c["n_routed_experts"] + 3 * d * f * (c["num_experts_per_tok"]
                                                     + c["n_shared_experts"])


def token_params(c: dict) -> int:
    layers = c["num_hidden_layers"]
    return layers * attention_params(c) + sum(ffn_params(c, i) for i in range(layers))


def forward(c: dict, rows: int, t: int) -> float:
    """A causal forward in the full form over `rows` sequences of t tokens,
    without heads."""
    h = c["num_attention_heads"]
    pair = 2.0 * h * (c["qk_nope_head_dim"] + c["qk_rope_head_dim"] + c["v_head_dim"])
    return rows * (2.0 * token_params(c) * t + pair * c["num_hidden_layers"] * t * (t + 1) / 2)


def decode_step(c: dict, rows: int, positions: int) -> float:
    """One absorbed decode step of `rows` rows over `positions` cached rows,
    without the head."""
    h, lat = c["num_attention_heads"], c["kv_lora_rank"]
    per = 2.0 * h * (2 * lat + c["qk_rope_head_dim"])
    return rows * (2.0 * token_params(c) + per * c["num_hidden_layers"] * positions)


def serve_call(cfg_file: dict, n: int, k: int, lt: int, lp: int, max_gen: int, bucket: int,
               steps: int, t_ref: int) -> dict:
    """{stage: flop} of one call (the arguments as flops.serve_call's), the
    speech LM's stages counted with the MLA-MoE trunk."""
    out = flops.serve_call(cfg_file, n, k, lt, lp, max_gen, bucket, steps, t_ref)
    d = cfg_file["hidden_size"]
    vocab = cfg_file["ttts"]["gpt"]["number_mel_codes"]
    rows, p = n * k, lt + 2 + lp + 1
    out["gpt_prefill"] = forward(cfg_file, rows, p) + 2.0 * rows * d * vocab
    out["gpt_decode"] = sum(decode_step(cfg_file, rows, p + i + 1) + 2.0 * rows * d * vocab
                            for i in range(max_gen))
    out["gpt_latent"] = forward(cfg_file, n, lt + 2 + bucket + 2)
    return out
