"""PyTorch port parity of the GPT's long-context training route
(GPTConfig.flash_attention, GPTConfig.checkpointing, GPTConfig.fused_decode)
on the CPU, in f32, at TINY widths, inputs from a numpy seed:

- the plain versions of the route's kernels, flash_causal_forward_plain
  (O and each row's log2-sum-exp2) and flash_causal_backward_plain (dq, dk,
  dv by the explicit formulas), against jax.vjp of the causal attention
  the JAX package's flash route computes: the plain reference of its
  library kernel (jax.experimental.pallas.ops.tpu.flash_attention
  mha_reference_no_custom_vjp, whose causal mask and scale ttts_tpu/models/
  gpt.py _flash_causal_attention passes), and against torch autograd of
  flash_attention_plain; within 1e-5 of max |reference| (f32, the order of
  the sums apart), the gradients of max |reference| over dq, dk and dv
  together (at T=1, dq and dk are zero analytically: rounding noise on both
  sides);
- FlashCausal off the CPU refuses inputs outside the kernels' domain (f32
  compute, a head dim other than 32 or 64) with a ValueError naming the
  fix, rather than run the plain version there;
- one gpt_train_step with the flash route on (attention dropout 0, the
  other dropouts 0 so that both sides draw nothing) against JAX's
  gpt_train_step, which takes its einsum route on the CPU: losses and the
  grad norm within 1e-5 relative, the gradients (JAX's value_and_grad of
  the same loss) within test_torch_train_steps' tolerances, the updated
  parameters within 1e-6; FlashCausal ran once a layer and SDPA never. The
  weights come across through the existing GPT porter
  (porting.unified_voice_state_dict): the route adds no parameter;
- GPT2Block's gate, JAX's at ttts_tpu/models/gpt.py:169-172 with the
  port's routes elsewhere;
- checkpointing=True: the same parameter names, loss and gradients as off,
  dropout on (the recomputed blocks draw the first pass's masks);
- fused_decode=False: inference_speech decodes through the plain decode.

The kernels themselves need the card: tests/test_torch_flash_kernels.py."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.flash_attention import mha_reference_no_custom_vjp

from test_api import TINY as JTINY
from test_torch_codec_synth import seeded_variables
from test_torch_config import to_port
from test_torch_train_steps import _gpt_batch, _grads_close, _port, _torch
from ttts_tpu.models import gpt as jgpt
from ttts_tpu.train import state as jstate
from ttts_tpu.train import steps as jsteps
from ttts_tpu_torch import porting
from ttts_tpu_torch.models import gpt
from ttts_tpu_torch.models.sampling import SamplingParams
from ttts_tpu_torch.ops.cuda import attention, decode_attention
from ttts_tpu_torch.ops.cuda.attention import (
    LOG2E,
    FlashCausal,
    flash_attention_plain,
    flash_causal_backward_plain,
    flash_causal_forward_plain,
    split_qkv,
)
from ttts_tpu_torch.train import state as tstate
from ttts_tpu_torch.train import steps as tsteps

TOL = 1e-5  # of max |reference|
FLASH_C = dataclasses.replace(JTINY.gpt, dropout=0.0, attn_dropout=0.0, flash_attention=True)
LR = 0.05


def _inputs(seed, t, d, b=2, h=2):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(4))
    return q, k, v, do


def _close(got, want, what, scale=None):
    """max |got - want| <= TOL * scale (default: max |want|)."""
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max() if scale is None else scale
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= TOL * scale, (what, err, scale)


def _close_grads(got, want):
    scale = max(np.abs(np.asarray(w, np.float64)).max() for w in want)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g, w, name, scale)


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("t", [1, 17, 64, 100, 127, 129, 257])
def test_plain_versions_match_jax_vjp(t, d):
    q, k, v, do = _inputs(t * 100 + d, t, d)

    def attend(q, k, v):  # (B, T, H, D) in and out, as the JAX package's route
        o, l, m = mha_reference_no_custom_vjp(
            *(jnp.transpose(x, (0, 2, 1, 3)) for x in (q, k, v)), causal=True,
            sm_scale=1.0 / math.sqrt(d), save_residuals=True)
        return jnp.transpose(o, (0, 2, 1, 3)), m + jnp.log(l)

    def fwd_bwd(q, k, v, do):
        out, vjp = jax.vjp(attend, q, k, v)
        return out, vjp((do, jnp.zeros_like(out[1])))

    (o_j, lse_j), (dq_j, dk_j, dv_j) = jax.jit(fwd_bwd)(*map(jnp.asarray, (q, k, v, do)))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = flash_causal_forward_plain(tq, tk, tv)
    _close(o, o_j, "o")
    _close(lse / LOG2E, lse_j, "lse")  # log2 units
    _close_grads(flash_causal_backward_plain(tq, tk, tv, o, lse, tdo), (dq_j, dk_j, dv_j))


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("t", [1, 17, 64, 100, 127, 129, 257])
def test_plain_backward_matches_autograd(t, d):
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(t + d, t, d))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(flash_attention_plain(*leaves, causal=True), leaves, do)
    o, lse = flash_causal_forward_plain(q, k, v)
    _close(o, flash_attention_plain(q, k, v, causal=True).detach(), "o")
    _close_grads(flash_causal_backward_plain(q, k, v, o, lse, do), want)


def test_flash_causal_function_over_fused_qkv():
    """FlashCausal over a fused [q; k; v] projection: its output and its one
    (B, T, 3 H D) gradient equal autograd through flash_attention_plain on
    the same views (the kernels' plain versions run on the CPU)."""
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(rng.standard_normal((2, 37, 3 * 2 * 32)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 37, 64)).astype(np.float32))
    a, b = qkv.clone().requires_grad_(), qkv.clone().requires_grad_()
    out = FlashCausal.apply(a, 2)
    ref = flash_attention_plain(*split_qkv(b, 2), causal=True).reshape(2, 37, 64)
    _close(out.detach(), ref.detach(), "out")
    (ga,), (gb,) = torch.autograd.grad(out, [a], g), torch.autograd.grad(ref, [b], g)
    assert ga.shape == qkv.shape
    _close(ga, gb, "dqkv")


@pytest.mark.parametrize("dtype,d,match", [(torch.float32, 64, "bfloat16.*train.amp"),
                                          (torch.bfloat16, 48, r"\(D 32 or 64\).*head dim")])
def test_flash_causal_refuses_outside_kernel_domain_off_cpu(dtype, d, match):
    """Off the CPU (a meta tensor stands for the card's: no kernel is
    reached) FlashCausal runs its kernels only: f32 compute or a head dim
    other than 32 or 64 raises a ValueError naming the fix, and no plain
    version runs in their place."""
    qkv = torch.empty(2, 16, 3 * 2 * d, dtype=dtype, device="meta", requires_grad=True)
    with pytest.raises(ValueError, match=match):
        FlashCausal.apply(qkv, 2)


class _Routes:
    """Counts of the GPT block's attention routes: FlashCausal, SDPA and
    attention.attend."""

    def __init__(self, monkeypatch):
        self.calls = {"flash": 0, "sdpa": 0, "attend": 0}
        apply, sdpa, attend = (FlashCausal.apply, torch.nn.functional.scaled_dot_product_attention,
                               attention.attend)
        monkeypatch.setattr(FlashCausal, "apply", self._wrap("flash", apply))
        monkeypatch.setattr(torch.nn.functional, "scaled_dot_product_attention",
                            self._wrap("sdpa", sdpa))
        monkeypatch.setattr(attention, "attend", self._wrap("attend", attend))

    def _wrap(self, name, fn):
        def f(*args, **kwargs):
            self.calls[name] += 1
            return fn(*args, **kwargs)
        return f


@pytest.fixture(scope="module")
def flash_gpt():
    model = jgpt.UnifiedVoice(FLASH_C)
    b = _gpt_batch()
    variables = seeded_variables(lambda: model.init(
        jax.random.key(0), *(jnp.asarray(b[k]) for k in
                             ("text", "text_lengths", "mel_codes", "wav_lengths"))))
    port = gpt.UnifiedVoice(to_port(FLASH_C))
    sd = porting.unified_voice_state_dict(variables)
    # the existing porter carries every parameter: the route adds none
    assert sorted(sd) == sorted(gpt.UnifiedVoice(to_port(JTINY.gpt)).state_dict())
    return model, variables, _port(port, sd)


def test_train_step_matches_jax(flash_gpt, monkeypatch):
    model, variables, port = flash_gpt
    b = _gpt_batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    key = jax.random.key(1)
    tx = jstate.make_adamw(lr=LR, warmup_steps=1, eps=1.0)
    jst = jstate.TrainState.create(apply_fn=None, params=variables, tx=tx)
    jst = jst.replace(step=jnp.asarray(0))
    jnew, jm = jax.jit(lambda s, b: jsteps.gpt_train_step(s, b, key, model))(jst, jb)

    def loss_fn(v):
        lt, lm, _ = model.apply(v, jb["text"], jb["text_lengths"], jb["mel_codes"],
                                jb["wav_lengths"], deterministic=False, rngs={"dropout": key})
        return 0.01 * lt + lm

    jgrads = jax.jit(jax.grad(loss_fn))(variables)
    state = tstate.TrainState.create(port, lambda ps: tstate.make_adamw(ps, LR, 1, eps=1.0))
    seen = []
    update = state.opt.update
    monkeypatch.setattr(state.opt, "update", lambda g, n: seen.append(g) or update(g, n))
    routes = _Routes(monkeypatch)
    m = tsteps.gpt_train_step(state, _torch(b), 0)
    assert routes.calls == {"flash": FLASH_C.layers, "sdpa": 0, "attend": 0}
    for k in ("loss", "loss_text", "loss_mel", "grad_norm"):
        assert abs(float(m[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k])), k
    names = [n for n, _ in port.named_parameters()]
    _grads_close(names, seen[0], porting.unified_voice_state_dict(jgrads))
    want = porting.unified_voice_state_dict(jnew.params)
    for n, p in zip(names, state.params):
        np.testing.assert_allclose(p.detach().numpy(), want[n], atol=1e-6, rtol=0, err_msg=n)


# (flash_attention, attn_dropout, train mode, grad mode) → the route taken
GATES = {
    "flash, train, attn dropout 0": (True, 0.0, True, True, "flash"),
    "flash, eval, grad": (True, 0.1, False, True, "flash"),
    "flash, train, attn dropout on": (True, 0.1, True, True, "sdpa"),
    "flash, eval, no grad": (True, 0.0, False, False, "attend"),
    "no flash, train": (False, 0.0, True, True, "sdpa"),
    "no flash, eval, grad": (False, 0.0, False, True, "attend"),
}


@pytest.mark.parametrize("case", sorted(GATES))
def test_gpt_block_gate(monkeypatch, case):
    flash, p_attn, train, grad, route = GATES[case]
    blk = gpt.GPT2Block(64, 2, 0.0, p_attn, flash=flash).train(train)
    routes = _Routes(monkeypatch)
    with torch.set_grad_enabled(grad):
        blk(torch.randn(2, 9, 64))
    assert routes.calls == {r: int(r == route) for r in routes.calls}


@pytest.mark.parametrize("flash", [False, True])
def test_checkpointing_keeps_names_loss_and_grads(flash):
    base = dataclasses.replace(to_port(JTINY.gpt), dropout=0.1, attn_dropout=0.0,
                               flash_attention=flash)
    torch.manual_seed(0)
    plain = gpt.UnifiedVoice(base).train()
    remat = gpt.UnifiedVoice(dataclasses.replace(base, checkpointing=True)).train()
    assert list(remat.state_dict()) == list(plain.state_dict())
    remat.load_state_dict(plain.state_dict())
    batch = _torch(_gpt_batch())
    out = []
    for model in (plain, remat):
        with tsteps.seeded(3, torch.device("cpu")):
            loss = tsteps.gpt_loss(model, batch)[0]
        out.append((loss, torch.autograd.grad(loss, list(model.parameters()))))
    assert float(out[0][0].detach()) == float(out[1][0].detach())
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-8)


def test_plain_decode_without_fused_decode(monkeypatch):
    """fused_decode=False: inference_speech and a bare block decode through
    decode_attention_plain, never pick or the kernel's wrapper, with the
    tokens of the fused default."""
    calls = {"kernel": 0, "plain": 0, "pick": 0}
    kernel, plain, pick = (decode_attention.decode_attention,
                           decode_attention.decode_attention_plain, decode_attention.pick)

    def count(name, fn):
        def f(*args):
            calls[name] += 1
            return fn(*args)
        return f

    cfg = to_port(JTINY.gpt)
    torch.manual_seed(0)
    fused = gpt.UnifiedVoice(cfg).eval()
    unfused = gpt.UnifiedVoice(dataclasses.replace(cfg, fused_decode=False)).eval()
    unfused.load_state_dict(fused.state_dict())
    n = 6
    gumbel = torch.from_numpy(np.random.default_rng(2).gumbel(
        size=(n, 2, cfg.number_mel_codes)).astype(np.float32))
    args = (torch.ones(2, 4, dtype=torch.long), torch.zeros(2, 3, dtype=torch.long), n,
            SamplingParams(), gumbel)
    with torch.no_grad():
        want = gpt.inference_speech(fused, *args)
        monkeypatch.setattr(decode_attention, "decode_attention", count("kernel", kernel))
        monkeypatch.setattr(decode_attention, "decode_attention_plain", count("plain", plain))
        monkeypatch.setattr(decode_attention, "pick", count("pick", pick))
        got = gpt.inference_speech(unfused, *args)
        assert calls["kernel"] == calls["pick"] == 0 and calls["plain"] > 0
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        blk = unfused.gpt.h[0]
        cache = tuple(torch.zeros(1, cfg.heads, 8, cfg.model_dim // cfg.heads)
                      for _ in range(2))
        before = calls["plain"]
        blk(torch.randn(1, 1, cfg.model_dim), cache, 3)
        assert calls["plain"] == before + 1 and calls["kernel"] == calls["pick"] == 0
