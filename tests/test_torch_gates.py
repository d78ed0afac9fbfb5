"""The port's shape gates: each kernel's domain test (beside its wrapper)
answers True at the serving path's full-width shapes (PERF.md section 6)
and False at TINY's (codec D=16, GPT dk=32, trunk C=64 with D=16), on
dtypes and shapes alone, and each model call site, through its op's
dispatch (`vq.nearest`, `decode_attention.pick`, `attention.attend`,
`resblock.scale_shift_resblock` and `resblock.gn_qkv`), takes the kernel's
wrapper only where its gate holds, else the kernel's plain version,
deciding before any launch. On the CPU every
wrapper runs its plain version, so the call sites are watched through
spies on the wrappers. Under autograd (grad mode on and an input that
requires grad) every dispatch takes the plain version, whose graph the
kernels (no backward) would cut: sentinels in place of the wrappers show
it."""

import dataclasses

import pytest
import torch

from test_api import TINY
from test_torch_config import to_port
from ttts_tpu_torch.api import cast_for_inference
from ttts_tpu_torch.models import clvp, diffusion_net, gpt, quantize
from ttts_tpu_torch.models.sampling import SamplingParams
from ttts_tpu_torch.ops.cuda import attention, decode_attention, resblock, vq

BF = torch.bfloat16


def _qkv_views(b, t, h, d, per_head: bool):
    """q, k, v as the models pass them: strided views of one fused tensor,
    per-head [q; k; v] (the diffusion trunk) or [q; k; v] blocks (the GPT)."""
    if per_head:
        qkv = torch.empty(b, t, h, 3 * d, dtype=BF)
        return qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    qkv = torch.empty(b, t, 3 * h * d, dtype=BF)
    return tuple(qkv[..., i * h * d:(i + 1) * h * d].reshape(b, t, h, d) for i in range(3))


def _resblock_args(b, t, c):
    e = lambda *s, dt=torch.float32: torch.empty(*s, dtype=dt)  # noqa: E731
    return (e(b, t, c, dt=BF), e(c), e(c), e(c, c, dt=BF), e(c), e(b, c), e(b, c),
            e(3, c, c, dt=BF), e(c))


def test_gates_at_full_width_and_tiny():
    v = TINY.vqvae.inter_channels
    # VQ: the codec's N=125 (5 s) and N=500 rows of 192 against 1024 codes
    assert vq.kernel_fits(torch.empty(500, 192), torch.empty(1024, 192))
    assert vq.kernel_fits(torch.empty(125, 192), torch.empty(1024, 192))
    assert not vq.kernel_fits(torch.empty(125, v), torch.empty(TINY.vqvae.codebook_bins, v))
    assert not vq.kernel_fits(torch.empty(125, 192, dtype=torch.float64),
                              torch.empty(1024, 192, dtype=torch.float64))
    # decode: bf16 at dk=64 (B=4 H=8); TINY's GPT has dk 64/2 = 32
    assert decode_attention.kernel_fits(BF, 64)
    assert not decode_attention.kernel_fits(torch.float32, 64)
    dk = TINY.gpt.model_dim // TINY.gpt.heads
    assert dk == 32 and not decode_attention.kernel_fits(BF, dk)
    # attention: the trunk (bias), CLVP (no bias), the GPT latent (causal)
    assert attention.kernel_fits(*_qkv_views(2, 1600, 16, 32, True))
    assert attention.kernel_fits(*(torch.empty(4, 400, 16, 64, dtype=BF) for _ in range(3)))
    assert attention.kernel_fits(*_qkv_views(1, 436, 8, 64, False))
    assert not attention.kernel_fits(*(torch.empty(1, 436, 8, 64) for _ in range(3)))
    d = TINY.diffusion_net.model_channels // TINY.diffusion_net.num_heads
    assert d == 16 and not attention.kernel_fits(*_qkv_views(2, 128, 4, d, True))
    # resblock and gn_qkv: the trunk at C=512 (32 groups); TINY's C=64
    assert resblock.resblock_fits(*_resblock_args(2, 1600, 512), groups=32)
    c = TINY.diffusion_net.model_channels
    assert not resblock.resblock_fits(*_resblock_args(2, 128, c),
                                      groups=diffusion_net.num_groups(c))
    gn = lambda b, t, c: (torch.empty(b, t, c, dtype=BF), torch.empty(c), torch.empty(c),  # noqa: E731
                          torch.empty(c, 3 * c, dtype=BF), torch.empty(3 * c))
    assert resblock.gn_qkv_fits(*gn(4, 1600, 512), groups=32)
    assert not resblock.gn_qkv_fits(*gn(2, 128, c), groups=diffusion_net.num_groups(c))


def test_gates_ignore_views_and_alignment():
    """A gate decides on dtypes and shapes alone: a view the attention kernel
    cannot read (D not contiguous, or a token stride not a multiple of 8)
    still passes it, so on the card it reaches the wrapper, which raises
    (tests/test_torch_attention.py holds `_strides` to that) rather than
    falling back."""
    b, t, h, d = 2, 5, 4, 32
    transposed = torch.zeros(b, t, d, h, dtype=BF).transpose(2, 3)
    odd = torch.zeros(b, t, h * d + 1, dtype=BF)[..., 1:].reshape(b, t, h, d)
    for x in (transposed, odd):
        assert attention.kernel_fits(x, x, x)
        with pytest.raises(ValueError, match="aligned"):
            attention._strides(x, "q")


def _spy(monkeypatch, module, kernel: str, plain: str) -> dict:
    """Count the calls of `module.kernel` and `module.plain` (each still
    runs the plain version)."""
    calls = {"kernel": 0, "plain": 0}
    run = getattr(module, plain)

    def wrap(which):
        def f(*args, **kwargs):
            calls[which] += 1
            return run(*args, **kwargs)
        return f

    monkeypatch.setattr(module, kernel, wrap("kernel"))
    monkeypatch.setattr(module, plain, wrap("plain"))
    return calls


@pytest.mark.parametrize("dim,heads,fits", [(128, 2, True), (64, 2, False)])
def test_gpt_decode_gate(monkeypatch, dim, heads, fits):
    calls = _spy(monkeypatch, decode_attention, "decode_attention", "decode_attention_plain")
    blk = cast_for_inference(gpt.GPT2Block(dim, heads))
    cache = tuple(torch.zeros(1, heads, 8, dim // heads, dtype=BF) for _ in range(2))
    with torch.no_grad():
        blk(torch.randn(1, 1, dim).to(BF), cache, 3)
    assert calls == ({"kernel": 1, "plain": 0} if fits else {"kernel": 0, "plain": 1})


@pytest.mark.parametrize("heads,fits", [(1, True), (2, False)])
def test_decode_picked_once_per_call(monkeypatch, heads, fits):
    """inference_speech picks the decode attention once per call (dk 64
    with one head of TINY's 64 wide GPT, dk 32 with two) and every layer's
    every step runs the pick."""
    calls = _spy(monkeypatch, decode_attention, "decode_attention", "decode_attention_plain")
    picks, pick = [], decode_attention.pick
    monkeypatch.setattr(decode_attention, "pick", lambda *a: picks.append(a) or pick(*a))
    cfg = dataclasses.replace(to_port(TINY.gpt), heads=heads)
    model = cast_for_inference(gpt.UnifiedVoice(cfg).eval())
    steps = []
    decode_one = model.decode_one
    monkeypatch.setattr(model, "decode_one", lambda *a: steps.append(a) or decode_one(*a))
    n = 5
    gumbel = torch.zeros(n, 2, cfg.number_mel_codes)
    gumbel[:, :, cfg.stop_mel_token] = -1e9  # no stop: every step decodes
    with torch.no_grad():
        gpt.inference_speech(model, torch.ones(2, 4, dtype=torch.long),
                             torch.zeros(2, 3, dtype=torch.long), n, SamplingParams(), gumbel)
    assert picks == [(BF, 64 // heads)] and len(steps) == n
    ran = cfg.layers * len(steps)
    assert calls == ({"kernel": ran, "plain": 0} if fits else {"kernel": 0, "plain": ran})


@pytest.mark.parametrize("dim,heads,fits", [(128, 2, True), (96, 2, False)])
def test_gpt_causal_gate(monkeypatch, dim, heads, fits):
    """dk 64 (the default GPT) and dk 48 (no kernel for it); TINY's dk 32 fits."""
    calls = _spy(monkeypatch, attention, "flash_attention", "flash_attention_plain")
    blk = cast_for_inference(gpt.GPT2Block(dim, heads))
    with torch.no_grad():
        blk(torch.randn(1, 5, dim).to(BF))
    assert calls == ({"kernel": 1, "plain": 0} if fits else {"kernel": 0, "plain": 1})


@pytest.mark.parametrize("d,fits", [(32, True), (16, False)])
def test_vq_gate(monkeypatch, d, fits):
    calls = _spy(monkeypatch, vq, "vq_nearest", "vq_nearest_plain")
    quantize.nearest(torch.randn(7, d), torch.randn(32, d))
    assert calls == ({"kernel": 1, "plain": 0} if fits else {"kernel": 0, "plain": 1})


@pytest.mark.parametrize("c,heads,fits", [(512, 16, True), (64, 4, False)])
def test_trunk_gates(monkeypatch, c, heads, fits):
    """The full-width trunk (C=512, D=32) and TINY's (C=64, D=16): the
    resblock, the bias attention and, with fused_gn, the fused GN → qkv."""
    want = {"kernel": 1, "plain": 0} if fits else {"kernel": 0, "plain": 1}
    res = _spy(monkeypatch, resblock, "fused_scale_shift_resblock",
               "fused_scale_shift_resblock_plain")
    att = _spy(monkeypatch, attention, "flash_attention", "flash_attention_plain")
    qkv = _spy(monkeypatch, resblock, "fused_gn_qkv", "fused_gn_qkv_plain")
    x = torch.randn(1, 8, c).to(BF)
    with torch.no_grad():
        cast_for_inference(diffusion_net.ScaleShiftResBlock(c, c))(x, torch.randn(1, c))
        blk = cast_for_inference(diffusion_net.AttentionBlock(c, heads, fused_gn=True))
        blk(x, torch.zeros(heads, 15))
    assert res == att == qkv == want


@pytest.mark.parametrize("dim_head,fits", [(64, True), (48, False)])
def test_clvp_gate(monkeypatch, dim_head, fits):
    calls = _spy(monkeypatch, attention, "flash_attention", "flash_attention_plain")
    attn = cast_for_inference(clvp.Attention(64, 2, dim_head))
    with torch.no_grad():
        attn(torch.randn(2, 6, 64).to(BF))
    assert calls == ({"kernel": 1, "plain": 0} if fits else {"kernel": 0, "plain": 1})


# ------------------------------------------------ the gates under autograd


def _sentinel(monkeypatch, module, kernel: str) -> list:
    """Replace `module.kernel` with a sentinel that records its call."""
    hits = []

    def sentinel(*args, **kwargs):
        hits.append(kernel)
        return "sentinel"

    monkeypatch.setattr(module, kernel, sentinel)
    return hits


def _dispatches():
    """(dispatch module, raw wrapper, call(requires_grad)) of each op, at
    shapes and dtypes inside its kernel's domain; requires_grad marks the
    first floating input."""
    def attend(rg):
        q, k, v = _qkv_views(1, 8, 2, 64, False)
        return attention.attend(q.detach().requires_grad_(rg), k, v, causal=True)

    def res(rg):
        args = list(_resblock_args(1, 8, 128))
        args[0] = torch.zeros_like(args[0]).requires_grad_(rg)
        return resblock.scale_shift_resblock(*args, groups=8)

    def qkv(rg):
        return resblock.gn_qkv(torch.zeros(1, 8, 128, dtype=BF).requires_grad_(rg),
                               torch.ones(128), torch.zeros(128),
                               torch.zeros(128, 384, dtype=BF), torch.zeros(384), groups=8)

    def nearest(rg):
        return vq.nearest(torch.randn(7, 32).requires_grad_(rg), torch.randn(16, 32))

    def pick(rg):
        q = torch.zeros(1, 2, 64, dtype=BF).requires_grad_(rg)
        return decode_attention.pick(BF, 64, q)(q, q, q, *(torch.zeros(1, 2, 8, 64, dtype=BF)
                                                           for _ in range(2)), 3)

    return {"attend": (attention, "flash_attention", attend),
            "scale_shift_resblock": (resblock, "fused_scale_shift_resblock", res),
            "gn_qkv": (resblock, "fused_gn_qkv", qkv),
            "nearest": (vq, "vq_nearest", nearest),
            "pick": (decode_attention, "decode_attention", pick)}


@pytest.mark.parametrize("op", list(_dispatches()))
def test_dispatch_takes_plain_version_when_autograd_records(monkeypatch, op):
    """The kernel's wrapper is reached only where autograd would not record
    the call: never with an input that requires grad under grad mode (the
    kernels have no backward), and again under torch.no_grad."""
    module, kernel, call = _dispatches()[op]
    hits = _sentinel(monkeypatch, module, kernel)
    assert call(False) == "sentinel" and hits == [kernel]
    out = call(True)
    assert isinstance(out, torch.Tensor) and len(hits) == 1
    if out.is_floating_point():
        assert out.requires_grad  # the plain version kept the graph
    with torch.no_grad():
        assert call(True) == "sentinel" and len(hits) == 2


def test_records_grad_rule():
    from ttts_tpu_torch.ops.cuda import _build

    x = torch.zeros(2, requires_grad=True)
    assert _build.records_grad(x, None, torch.zeros(2))
    assert not _build.records_grad(torch.zeros(2), None)
    assert not _build.records_grad(torch.zeros(2, dtype=torch.long))
    with torch.no_grad():
        assert not _build.records_grad(x)
    with pytest.raises(ValueError, match="requires grad"):
        _build.refuse_grad("k", x)
    _build.refuse_grad("k", x.detach())
