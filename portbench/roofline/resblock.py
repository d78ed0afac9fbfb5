"""The diffusion trunk's scale-shift resblock (csrc/resblock.cu), one call
of five launches (`gn_stats_kernel`, two `gn_act_kernel`, two
`rb_wgmma_kernel`) at x (B, T, C), bf16: the 1x1 and the 3-tap products
(8 B T C^2), reading x, w1, w3 and the vectors, writing the output."""

KERNELS = r"gn_stats_kernel|gn_act_kernel|rb_wgmma_kernel"
LAUNCHES_PER_CALL = 5


def work(b: int, t: int, c: int) -> dict:
    return {"flop": 8 * b * t * c * c, "bytes": 4 * b * t * c + 8 * c * c + 16 * c + 8 * b * c}
