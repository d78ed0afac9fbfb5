"""Traffic kind `serve_batch_lm`: serve_batch's closed loop of batched
zero-shot calls (portbench/traffic/serve_batch.py: the same parameters,
texts, voice, draws, captures and check) with the GPT's trunk a public LLM
block, the configuration's top-level keys (a published config.json's, read
as an MLAMoEConfig): `TextToSpeech(..., trunk=...)`.

Weights: the benchmark's rule, drawn on the card from the seed, UnifiedVoice
without its trunk as module "gpt" and the trunk a layer at a time as module
"gpt.h.<i>" (each layer's f32 draw made, loaded into the program's bf16 and
dropped before the next), so no f32 copy of the whole trunk is made; the
router's matrix at N(0, 1/hidden_size), its fan-in, and its correction
bias at the published modelling's initial value, zero (the configuration's
`assumed`: a trained bias balances the experts' load, a random one skews
it: at 64 decode rows 44-46 of 64 experts took pairs a step with it drawn,
59-60 with it at zero).

`RouteCapture`, hooks on the program's routed layers registered in
set-up (the model has no part in it), keeps the experts each routed layer
chooses: every call keeps the decode's choices at each cache row and the
latent pass's. The check runs the plain reference (portbench/reference/
mla_moe.py) a layer at a time in f32, each layer's weights made again from
the seed at its turn; where the reference's own choice at a position
differs from the program's only among experts whose choice scores lie
within the parameter `route_band` of its boundary between the 6th and 7th,
it takes the program's (rounding swaps such experts), and counts it:
`route_differ`, `route_taken` and `route_gap` (the largest distance from
the boundary of an expert in dispute) end standard error, held to no
limit. The control takes the fp8 reference's choices the same way.

A call also records the moe counters' change (ops/cuda/moe.counters: pairs
and experts read, by pairs a launch), read after the call has returned its
host arrays.
"""

from __future__ import annotations

import functools
import math

import torch

from portbench import check as chk
from portbench import lowp
from portbench import weights as wts
from portbench.reference import mla_moe as ref_lm
from portbench.traffic import serve_batch as sb

TRUNK = "gpt.h."  # the trunk's state-dict keys in UnifiedVoice


class RouteCapture:
    """The experts each routed layer of `gpt` (a UnifiedVoice with the
    MLA-MoE trunk) chooses, taken by a forward pre-hook on the layer (its
    input's rows and length, its cache and the cache row) and a forward hook
    on its router (the choice). `decode[i]`: layer i's (B, L, k) int64
    buffer of a cached pass's choices at their cache rows (made at the first
    pass with caches of that size, which on the card is the decode graphs'
    warm-up, never a capture; inside a captured step the row comes from the
    device word, so every replay writes its own); `latent[i]`: the (B, T,
    k) choice of the last pass without a cache. None for a dense layer.
    Register before the first call: a step captured earlier replays
    without the writes (release `gpt.decode_graph` to capture anew)."""

    def __init__(self, gpt):
        n = len(gpt.gpt.h)
        self.decode: list = [None] * n
        self.latent: list = [None] * n
        self._at: list = [None] * n
        self._pos = self._row = None  # a decode step's device word and its int64 copy
        self.handles = []
        for i, block in enumerate(gpt.gpt.h):
            if block.routed:
                self.handles += [
                    block.register_forward_pre_hook(functools.partial(self._where, i)),
                    block.mlp.gate.register_forward_hook(functools.partial(self._write, i))]

    def _where(self, i: int, block, args) -> None:
        x, cache, pos = (tuple(args) + (None, 0))[:3]
        self._at[i] = x.shape[:2], cache, pos

    def _write(self, i: int, router, args, out) -> None:
        (b, t), cache, pos = self._at[i]
        self._at[i] = None  # the caches are the program's to free
        idx = out[0].view(b, t, -1)
        if cache is None:
            self.latent[i] = idx
            return
        buf = self.decode[i]
        if buf is None or buf.shape[:2] != cache.shape[:2] or buf.device != cache.device:
            if cache.is_cuda and torch.cuda.is_current_stream_capturing():
                raise RuntimeError("RouteCapture: caches first seen inside a capture")
            buf = self.decode[i] = torch.zeros(*cache.shape[:2], idx.shape[-1],
                                               dtype=idx.dtype, device=cache.device)
        if not isinstance(pos, torch.Tensor):
            buf[:, pos: pos + t] = idx
        else:  # a decode step (t = 1): the row cast once a step, a copy a layer
            if pos is not self._pos:
                self._pos, self._row = pos, pos.long()
            buf.index_copy_(1, self._row, idx)

    def remove(self) -> None:
        for h in self.handles:
            h.remove()
        self.handles = []
        self._pos = self._row = None


def layer_state(ctx, i: int, shapes) -> dict:
    """Layer i's weights (the block's own keys) from the seed, as module
    "gpt.h.<i>"; the router's matrix at N(0, 1/hidden_size) and its
    correction bias zero (see the module docstring)."""
    state = wts.make_state(shapes, ctx.seed, f"{TRUNK}{i}", ctx.device)
    w = state.get("mlp.gate.weight")
    if w is not None:
        w.mul_(math.sqrt(min(w.shape) / w.shape[1]))
        state["mlp.gate.e_score_correction_bias"].zero_()
    return state


def load_gpt(ctx, gpt) -> None:
    """The program's UnifiedVoice weights: all but the trunk in one draw
    (serve_batch's, the stop code held down), then each layer's."""
    shapes = wts.shapes_of(gpt)
    rest = [(k, s) for k, s in shapes if not k.startswith(TRUNK)]
    missing, unexpected = gpt.load_state_dict(sb.make_weights(ctx, "gpt", rest), strict=False)
    if unexpected or any(not k.startswith(TRUNK) for k in missing):
        raise RuntimeError(f"gpt weights: unexpected {unexpected}, missing {missing}")
    for i, block in enumerate(gpt.gpt.h):
        block.load_state_dict(layer_state(ctx, i, wts.shapes_of(block)), strict=True)


def setup(ctx) -> None:
    from ttts_tpu_torch.api import PRESETS, TextToSpeech
    from ttts_tpu_torch.config import MLAMoEConfig
    from ttts_tpu_torch.ops.cuda import moe

    p = ctx.params
    preset = PRESETS[p["preset"]]
    if (preset["num_autoregressive_samples"], preset["diffusion_iterations"]) != (
            p["candidates"], p["diffusion_steps"]):
        raise ValueError(f"preset {p['preset']!r} is {preset}, the workload file says "
                         f"{p['candidates']} candidates and {p['diffusion_steps']} steps")
    tts = TextToSpeech(sb.port_config(ctx.cfg), device=ctx.device, seed=0,
                       trunk=MLAMoEConfig.from_published(ctx.cfg))
    with torch.no_grad():
        for name, mod in sb.modules_of(tts).items():
            if name == "gpt":
                load_gpt(ctx, mod)
            else:
                mod.load_state_dict(sb.make_weights(ctx, name, wts.shapes_of(mod)), strict=True)
    ctx.routes = RouteCapture(tts.gpt)
    tts._cond_cache.clear()
    ctx.tts = tts
    ctx.voice = sb.synthetic_voice(p["voice_seconds"], p["voice_rate"], ctx.seed)
    ctx.capture = {}

    def latent(m, a, out):
        ctx.capture["latent"] = out
        ctx.capture["latent_routes"] = list(ctx.routes.latent)

    ctx.hooks = [
        tts.gpt.register_forward_hook(latent),
        tts.vocos.register_forward_pre_hook(lambda m, a: ctx.capture.__setitem__("mel", a[0])),
        tts.clvp.register_forward_hook(lambda m, a, out: ctx.capture.__setitem__("sims", out)),
    ]
    prompt, refer = tts.get_conditioning(ctx.voice, p["voice_rate"], "voice")
    ctx.lp, ctx.t_ref = -(-prompt.shape[1] // 16) * 16, refer.shape[1]
    # warm up: a call of the same sizes with draws of their own
    sb._call(ctx, sb.texts_of(p, ctx.seed, -1), sb.call_seed(ctx.seed, -1))
    ctx.moe_seen = moe.counters()


stage_times = sb.stage_times
end_to_end = sb.end_to_end


def unit(ctx, i: int) -> dict:
    from ttts_tpu_torch.ops.cuda import moe

    r = sb.unit(ctx, i)
    r["routes"] = {"decode": [None if b is None else b.to(torch.int16)
                              for b in ctx.routes.decode],
                   "latent": ctx.capture.pop("latent_routes", None)}
    now = moe.counters()
    seen = ctx.moe_seen["by_pairs"]
    r["moe"] = {p: [a - b for a, b in zip(v, seen.get(p, (0, 0)))]
                for p, v in now["by_pairs"].items() if v != seen.get(p)}
    ctx.moe_seen = now
    return r


class LayerwiseLM(ref_lm.UnifiedVoiceLM):
    """The reference speech LM with its layers made from the seed at their
    turn; `lowered` rounds each made layer to fp8 (the control);
    `hint_from`, another such model, runs the same pass first and its
    choices are the routes this one may take."""

    lowered = False
    hint_from = None

    def layer(self, i: int):
        block = super().layer(i)
        return lowp.lower(block) if self.lowered else block

    def _hint(self, phase: str, run) -> None:
        other = self.hint_from
        if other is not None:
            other.record = []
            run(other)
            self.routes = {phase: other.record}
            other.record = None

    def decode_logits(self, text, prompt_codes, served):
        self._hint("decode", lambda m: m.decode_logits(text, prompt_codes, served))
        return super().decode_logits(text, prompt_codes, served)

    def forward(self, *args, **kw):
        self._hint("latent", lambda m: m(*args, **kw))
        return super().forward(*args, **kw)


class LMServeReference(chk.ServeReference):
    """chk.ServeReference with the speech LM's reference made a layer at a
    time (LayerwiseLM) in place of the GPT-2 one."""

    def __init__(self, ctx):
        from portbench.reference import clvp, diffusion_net, vocos, vqvae

        c = self.cfg = chk.ref_config(ctx.cfg)
        self.device = dev = ctx.device
        lm = ref_lm.Config.of(ctx.cfg)

        def make_layer(i: int):
            block = chk._built(lambda: ref_lm.Block(lm, i), dev)
            block.load_state_dict(layer_state(ctx, i, wts.shapes_of(block)), strict=True)
            return block.eval().requires_grad_(False)

        self.models = {
            "gpt": chk._built(lambda: LayerwiseLM(c.gpt, lm, make_layer), dev),
            "clvp": chk._built(lambda: clvp.CLVP(c.clvp), dev),
            "diffusion": chk._built(lambda: diffusion_net.AA_diffusion(c.diffusion_net), dev),
            "vocos": chk._built(lambda: vocos.Vocos(c.vocos), dev),
            "codec": chk._built(lambda: vqvae.SynthesizerTrn(
                c.vqvae, spec_channels=c.audio.filter_length // 2 + 1), dev),
        }
        with torch.no_grad():
            for name, m in self.models.items():
                m.load_state_dict(sb.make_weights(ctx, name, wts.shapes_of(m)), strict=True)
                m.eval().requires_grad_(False)
        self.prompt, self.refer_mel = self._conditioning(ctx.voice, ctx.params["voice_rate"])
        from tokenizers import Tokenizer

        self.tok = Tokenizer.from_file(str(chk.ASSET))

    def lowered(self) -> "LMServeReference":
        other = super().lowered()
        other.models["gpt"].lowered = True
        return other


def checked(ctx, records) -> list:
    """serve_batch's checked calls; the route capture goes with the
    program's state, and the other calls' routes are freed."""
    ctx.routes.remove()
    del ctx.routes
    calls = sb.checked(ctx, records)
    for r in records:
        if not any(r is c for c in calls):
            r["routes"] = None
    return calls


def readings(ctx, calls, ref: LMServeReference, control=None) -> dict:
    """serve_batch's readings a call at a time, the reference's speech LM
    given the program's routes of the rows it compares (or, with `control`,
    the control's), and the routing tallies."""
    p = ctx.params
    k, stride = int(p["candidates"]), int(p["greedy_stride"])
    gpt = ref.models["gpt"]
    gpt.band, gpt.tally = float(p["route_band"]), {}
    out: dict = {}
    for call in calls:
        if control is None:
            pick = call["check"]
            rows = [t * k + j for t in pick for j in range(k) if (t * k + j) % stride == 0]
            gpt.routes = {phase: [None if b is None else b[torch.as_tensor(sel, device=b.device)]
                                  for b in call["routes"][phase]]
                          for phase, sel in (("decode", rows), ("latent", pick))}
        for name, v in chk.serve_readings(ctx, [call], ref, sb.noise_of(ctx), control).items():
            out[name] = max(out.get(name, 0.0), v)
    out.update({name: float(v) for name, v in gpt.tally.items()})
    return out


def check(ctx, records) -> list:
    """The numbers compared (see portbench/check.py), on texts of calls of
    the window drawn from the seed, after the program's state is freed."""
    calls = checked(ctx, records)
    return chk.compared(ctx.limits, readings(ctx, calls, LMServeReference(ctx)))


def control(ctx, records) -> dict:
    """The control's readings on the texts the check would take: the
    reference lowered to fp8 in the program's place, its routes the
    reference's hint."""
    calls = checked(ctx, records)
    ref = LMServeReference(ctx)
    low = ref.lowered()
    object.__setattr__(ref.models["gpt"], "hint_from", low.models["gpt"])  # not a submodule
    return readings(ctx, calls, ref, low)

