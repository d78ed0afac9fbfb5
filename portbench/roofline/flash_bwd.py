"""The GPT flash route's causal backward (csrc/attention_bwd.cu, the dQ
kernel `flash_bwd_dq_sm90` then the dK/dV kernel `flash_bwd_dkv_sm90`) at
(B, T, H, D), bf16, the two launches of one call counted together: five
products over the causal pairs (S, dP, dV, dQ, dK), one exp2 a pair,
reading q, k, v, O, dO (bf16) and lse2 (f32), writing dq, dk, dv."""

KERNELS = r"flash_bwd_(dq|dkv)_sm90"
LAUNCHES_PER_CALL = 2


def work(b: int, t: int, h: int, d: int) -> dict:
    pairs = b * h * t * (t + 1) / 2
    return {"flop": 10 * pairs * d, "exp2": pairs,
            "bytes": 8 * b * t * h * d * 2 + b * h * t * 4}
