"""The grouped SwiGLU expert kernel (csrc/moe_experts.cu: a call launches
`moe_experts_kernel<0>`, gate and up, then `moe_experts_kernel<1>`, down)
on `pairs` (token, expert) pairs of width d over `experts_read` experts with
at least one pair, expert width f, bf16: three products of 2 d f flop a
pair; each expert that has pairs read once (3 d f bf16 values: 17.3 MB at
2048 x 1408), and a pair's activation row read, h written and read again
(bf16), its y row written (f32) and its weight read. The counts come from
the program's moe counters (pairs and experts read, summed over the calls
of one pair count, which all lie on one side of the ridge)."""

KERNELS = r"moe_experts_kernel"
LAUNCHES_PER_CALL = 2


def work(pairs: int, experts_read: int, d: int, f: int) -> dict:
    return {"flop": 6.0 * d * f * pairs,
            "bytes": 6.0 * d * f * experts_read + pairs * (2.0 * d + 4.0 * f + 4.0 * d + 4.0)}
