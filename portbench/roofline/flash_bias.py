"""The diffusion trunk's attention with a Toeplitz bias strip
(csrc/attention.cu, `flash_kernel_sm90<32, false, true>`) at (B, T, H, D),
bf16: the two products over all T x T pairs, reading q, k, v and the
(H, 2T - 1) f32 strip, writing O. The exp2 are left out of the count, as
the bound this repository has quoted for the kernel always did."""

KERNELS = r"flash_kernel_sm90<32, false, true>"


def work(b: int, t: int, h: int, d: int) -> dict:
    return {"flop": 4 * b * h * t * t * d, "bytes": 4 * b * t * h * d * 2 + h * (2 * t - 1) * 4}
