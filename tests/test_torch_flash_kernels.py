"""The GPT training route's kernels on the card (marker `card`; each test
skips without a CUDA device, decided inside the `card` fixture): the
forward kernel with its log2-sum-exp2 output (flash_causal_forward,
csrc/attention_fwd.cu; two calls bit-equal) and the backward kernels
(flash_causal_backward, csrc/attention_bwd.cu) against their plain
versions on the same bf16 inputs, FlashCausal's gradient over a
fused qkv against autograd of the plain version, the launch counts (one
forward, and two backward: the dQ and the dK/dV kernels), and the route's
refusal of f32 compute on the card, the backward launched from a thread
that has made no CUDA call yet (autograd's backward thread), and two
backward calls on the same inputs bit-equal.
Imports torch and the port only (the card's machine has no JAX).

Limits, as chip_smoke.py's phase (p): O rel_l2 <= 5e-3 (the kernel rounds P
to bf16 before P.V), lse2 max_abs <= 1e-4 (f32 statistics of the same bf16
products), dq / dk / dv rel_l2 <= 1e-2 (P and dS rounded to bf16 before
their products), the denominator at least 1e-3 of the whole gradient's
norm (dq and dk are zero analytically at T=1).

    python -m pytest tests/test_torch_flash_kernels.py -q   # on a card
"""

import threading

import pytest
import torch

from ttts_tpu_torch.ops.cuda import attention
from ttts_tpu_torch.ops.cuda.attention import (
    FlashCausal,
    flash_attention_plain,
    flash_causal_backward,
    flash_causal_backward_plain,
    flash_causal_forward,
    flash_causal_forward_plain,
    split_qkv,
)

pytestmark = pytest.mark.card
O_TOL, LSE_TOL, GRAD_TOL, GRAD_FLOOR = 5e-3, 1e-4, 1e-2, 1e-3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    return torch.Generator("cuda").manual_seed(0)


def _rel(got, want, floor=0.0):
    got, want = got.float(), want.float()
    return float((got - want).norm()) / max(float(want.norm()), floor)


def _inputs(g, b, t, h, d):
    qkv = torch.randn(b, t, 3 * h * d, generator=g, device="cuda").to(torch.bfloat16)
    do = torch.randn(b, t, h, d, generator=g, device="cuda").to(torch.bfloat16)
    return qkv, split_qkv(qkv, h), do


# T at the edges of the 64-row consumer warpgroups, the forward's 128-key
# tiles and 192-query blocks, the backward's dK/dV 128-row and dQ 192-row
# blocks (some or all consumer warpgroups of a block holding rows), at D=64
# and 32
EDGES = [(2, t, h, d) for h, d in ((8, 64), (4, 32))
         for t in (1, 63, 64, 65, 127, 128, 129, 191, 192, 193, 255, 256, 257)]


@pytest.mark.parametrize("b,t,h,d", [(2, 100, 8, 64), (2, 164, 8, 64), (1, 1796, 8, 64)]
                         + EDGES)
def test_kernels_match_plain_versions(card, b, t, h, d):
    _, (q, k, v), do = _inputs(card, b, t, h, d)
    o, lse = flash_causal_forward(q, k, v)
    o2, lse2 = flash_causal_forward(q, k, v)  # the forward repeats bit for bit
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    o_p, lse_p = flash_causal_forward_plain(q, k, v)
    assert _rel(o, o_p) <= O_TOL
    assert float((lse - lse_p).abs().max()) <= LSE_TOL
    got = split_qkv(flash_causal_backward(q, k, v, o, lse, do), h)
    want = flash_causal_backward_plain(q, k, v, o, lse, do)
    floor = GRAD_FLOOR * float(torch.cat([w.float().flatten() for w in want]).norm())
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel(a, w, floor) <= GRAD_TOL, name


@pytest.mark.parametrize("t,d", [(300, 64), (257, 32)])
def test_backward_repeats_bit_for_bit(card, t, d):
    """Two raw backward calls on the same inputs give the same bits: no
    atomics, a fixed order of every sum."""
    _, (q, k, v), do = _inputs(card, 2, t, 8 if d == 64 else 4, d)
    o, lse = flash_causal_forward(q, k, v)
    assert torch.equal(flash_causal_backward(q, k, v, o, lse, do),
                       flash_causal_backward(q, k, v, o, lse, do))


def test_flash_causal_gradient_and_launches(card):
    qkv, _, do = _inputs(card, 2, 200, 8, 64)
    grad = do.reshape(2, 200, 512)
    launches = dict(attention.flash_attention.launches)
    a = qkv.clone().requires_grad_()
    (got,) = torch.autograd.grad(FlashCausal.apply(a, 8), a, grad)
    counts = attention.flash_attention.launches
    assert counts["causal_lse"] == launches["causal_lse"] + 1
    assert counts["causal_bwd"] == launches["causal_bwd"] + 2
    b = qkv.float().requires_grad_()
    (want,) = torch.autograd.grad(
        flash_attention_plain(*split_qkv(b, 8), causal=True).reshape(2, 200, 512), b,
        grad.float())
    assert got.shape == qkv.shape and got.dtype == torch.bfloat16
    assert _rel(got, want) <= GRAD_TOL


def test_raw_wrappers_refuse_grad(card):
    _, (q, k, v), do = _inputs(card, 1, 64, 2, 64)
    with pytest.raises(ValueError, match="requires grad"):
        flash_causal_forward(q.clone().requires_grad_(), k, v)
    o, lse = flash_causal_forward(q, k, v)
    with pytest.raises(ValueError, match="requires grad"):
        flash_causal_backward(q, k, v, o, lse, do.clone().requires_grad_())


def test_flash_causal_refuses_f32_on_card(card):
    """f32 compute (train.amp off) on the card raises, naming the fix,
    instead of running the plain version's (B, H, T, T) f32 tensors."""
    qkv, _, _ = _inputs(card, 1, 64, 2, 64)
    launches = dict(attention.flash_attention.launches)
    with pytest.raises(ValueError, match="train.amp"):
        FlashCausal.apply(qkv.float().requires_grad_(), 2)
    assert attention.flash_attention.launches == launches


def test_backward_from_a_fresh_thread(card):
    """The backward's entry point from a thread with no current CUDA
    context (autograd's backward thread on device 0 is one until a torch
    kernel runs in it): the same gradient as from this thread."""
    qkv, (q, k, v), do = _inputs(card, 2, 200, 8, 64)
    o, lse = flash_causal_forward(q, k, v)
    out = {}
    worker = threading.Thread(
        target=lambda: out.update(grad=flash_causal_backward(q, k, v, o, lse, do)))
    worker.start()
    worker.join()
    assert "grad" in out, "the backward raised in a fresh thread"
    assert torch.equal(out["grad"], flash_causal_backward(q, k, v, o, lse, do))
