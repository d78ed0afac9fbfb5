"""The GPT flash route's causal forward with its row statistic
(csrc/attention_fwd.cu, `flash_fwd_sm90`) at (B, T, H, D), bf16: the two
products Q.K^T and P.V over the causal pairs, one exp2 a pair, reading q,
k, v and writing O (bf16) and lse2 (f32)."""

KERNELS = r"flash_fwd_sm90"


def work(b: int, t: int, h: int, d: int) -> dict:
    pairs = b * h * t * (t + 1) / 2
    return {"flop": 4 * pairs * d, "exp2": pairs, "bytes": 4 * b * t * h * d * 2 + b * h * t * 4}
