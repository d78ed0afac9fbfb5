"""The comparison that decides `correct`: what the timed path produced,
against the plain f32 reference of portbench/reference/ (TF32 off), run
once the window has closed and the program's state is freed.

Serving (a sample of the window's calls, and of each call's texts, drawn
from the seed; the longest text always among them):
  decode_gap  the widest gap by which a served code's logit, after the
              repetition penalty, lies below the reference's best at its
              position, over the greedy rows (argmax is the draw there); the
              reference runs one causal forward over each row's text, prompt
              and served codes, so it checks the decode through the cache
  clvp_rel    the rerank's similarities of every candidate: the largest
              error over the largest reference similarity
  latent_rel  the GPT latent of the winners (relative L2)
  mel_rel     the diffusion output: the reference's own latent, conditioning
              and DPM++(2M) from the same start noise (relative L2)
  wav_rel     the Vocos waveform of the program's mel (relative L2)
Training (the first three steps, which set-up drives through the window's
own call):
  loss_rel    the widest relative gap of a step's loss
  grad_gap    the worst leaf's gap between the norms of the first gradient
              as the optimizer got it, against the reference's norm of that
              leaf or the median leaf's, whichever is larger
  change_gap  the same of the parameters' change over the three steps; an
              element whose first reference gradient is under a thousandth of
              the median leaf's RMS gradient moves by round-off alone (a
              key's bias under softmax) and is left out on both sides

With `control` the reference lowered to fp8 (portbench.lowp) takes the
program's place: its codes at each position of the same served rows, its
similarities, latent, mel and waveform, its steps.
"""

from __future__ import annotations

import copy
import pathlib
import sys
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from portbench import lowp
from portbench.reference import config as rconfig

ASSET = pathlib.Path(__file__).resolve().parents[1] / "ttts_tpu_torch" / "assets" / \
    "gpt_tts_tokenizer.json"


def compared(limits: Dict[str, float], readings: Dict[str, float]) -> list:
    """(name, reading, limit) of each reading the cell holds to a limit; a
    reading with none (its control gave no upper reading) goes to standard
    error only."""
    for name in sorted(set(readings) - set(limits)):
        print(f"not compared: {name} {readings[name]!r} (no limit)", file=sys.stderr)
    return [(name, readings[name], limits[name]) for name in readings if name in limits]


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.float()
    return float((got.float() - want).norm() / want.norm().clamp_min(1e-30))


def ref_config(cfg_file: dict):
    return rconfig._from_dict(rconfig.TTTSConfig, cfg_file["ttts"])


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _built(make, device):
    """A module made on `device`, with the buffers its constructor made from
    host arrays moved there too."""
    with torch.device(device):
        return make().to(device)


class ServeReference:
    """The serving pipeline's models in plain f32 with the cell's weights,
    and the voice's conditioning worked out again."""

    def __init__(self, ctx, make_weights: Callable):
        from portbench.reference import clvp, diffusion_net, gpt, vocos, vqvae

        c = self.cfg = ref_config(ctx.cfg)
        self.device = dev = ctx.device
        self.models = {
            "gpt": _built(lambda: gpt.UnifiedVoice(c.gpt), dev),
            "clvp": _built(lambda: clvp.CLVP(c.clvp), dev),
            "diffusion": _built(lambda: diffusion_net.AA_diffusion(c.diffusion_net), dev),
            "vocos": _built(lambda: vocos.Vocos(c.vocos), dev),
            "codec": _built(lambda: vqvae.SynthesizerTrn(
                c.vqvae, spec_channels=c.audio.filter_length // 2 + 1), dev),
        }
        with torch.no_grad():
            for name, m in self.models.items():
                shapes = [(k, tuple(v.shape)) for k, v in m.state_dict().items()
                          if v.is_floating_point()]
                m.load_state_dict(make_weights(ctx, name, shapes), strict=True)
                m.eval().requires_grad_(False)
        self.prompt, self.refer_mel = self._conditioning(ctx.voice, ctx.params["voice_rate"])
        from tokenizers import Tokenizer

        self.tok = Tokenizer.from_file(str(ASSET))

    def lowered(self) -> "ServeReference":
        """A copy whose models compute in fp8 (the control)."""
        other = copy.copy(self)
        other.models = {k: lowp.lower(copy.deepcopy(m)) for k, m in self.models.items()}
        return other

    @torch.no_grad()
    def _conditioning(self, voice, rate):
        from portbench.reference.mel import acoustic_mel_spectrogram, vits_spectrogram
        from portbench.reference.resample import resample

        c, dev = self.cfg, self.device
        wav = torch.as_tensor(np.asarray(voice, np.float32).reshape(1, -1), device=dev)
        wav32 = resample(wav, rate, c.audio.sampling_rate)
        hop = c.audio.hop_length
        wav32 = wav32[:, : (wav32.shape[1] // hop) * hop]
        spec = vits_spectrogram(wav32, c.audio.filter_length, hop,
                                c.audio.win_length).transpose(1, 2)
        codes = self.models["codec"].extract_code(wav32[..., None], spec,
                                                  torch.tensor([spec.shape[1]], device=dev))
        wav24 = resample(wav, rate, c.acoustic_mel.sample_rate)
        mel = acoustic_mel_spectrogram(wav24, c.acoustic_mel.sample_rate, c.acoustic_mel.n_fft,
                                       c.acoustic_mel.hop_length,
                                       c.acoustic_mel.n_mels).transpose(1, 2)
        prompt = codes[:, 0, :]
        lp = _round_up(prompt.shape[1], 16)
        return torch.nn.functional.pad(prompt, (0, lp - prompt.shape[1])), mel

    def text_ids(self, texts) -> torch.Tensor:
        """Pinyin texts → BPE ids (spaces as [SPACE]), zero-padded to a
        multiple of 16, as the serving entry prepares them."""
        ids = [self.tok.encode(t.replace(" ", "[SPACE]")).ids for t in texts]
        lt = _round_up(max(len(i) for i in ids), 16)
        return torch.as_tensor(np.stack([np.pad(np.asarray(i, np.int64), (0, lt - len(i)))
                                         for i in ids]), device=self.device)

    @torch.no_grad()
    def latent(self, ids, clean, code_lens):
        dev = self.device
        return self.models["gpt"](ids, torch.full((ids.shape[0],), ids.shape[1], device=dev),
                                  clean, torch.as_tensor(code_lens, device=dev) * 1024,
                                  return_latent=True)

    @torch.no_grad()
    def tail(self, latent, noise, steps: int):
        from portbench.reference.diffusion_net import (denormalize_tacotron_mel,
                                                       normalize_tacotron_mel)
        from portbench.reference.dpm import cfg_eps_fn, dpm_solver_pp_2m_sample

        net, b = self.models["diffusion"], latent.shape[0]
        out_len = noise.shape[1]
        refer = normalize_tacotron_mel(self.refer_mel).expand(b, -1, -1)
        cond = net.timestep_independent(latent, refer, out_len)
        strips = net.rel_biases(out_len)
        eps_fn = cfg_eps_fn(lambda x2, t2, e2: net.trunk(x2, t2, e2, strips), cond,
                            net.unconditioned(b, out_len), self.cfg.diffusion.cond_free_k)
        return denormalize_tacotron_mel(dpm_solver_pp_2m_sample(eps_fn, noise, steps=steps))


def penalized(logits: torch.Tensor, seen: torch.Tensor, penalty: float) -> torch.Tensor:
    """The repetition penalty on codes seen before: logit > 0 → /penalty,
    else *penalty."""
    pen = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, pen, logits)


def _seen(prompt: torch.Tensor, served: torch.Tensor, vocab: int) -> torch.Tensor:
    """(B, n, V) bool: each code seen in the prompt or among the served codes
    before position i."""
    b, n = served.shape
    counts = torch.zeros(b, vocab, dtype=torch.int32, device=served.device)
    counts.scatter_add_(1, prompt, torch.ones_like(prompt, dtype=torch.int32))
    onehot = torch.nn.functional.one_hot(served, vocab).to(torch.int32)
    before = torch.cumsum(onehot, dim=1) - onehot
    return (counts[:, None] + before) > 0


@torch.no_grad()
def serve_readings(ctx, calls: List[dict], ref: ServeReference,
                   noise: Callable[[dict, int, int], torch.Tensor],
                   control: Optional[ServeReference] = None) -> Dict[str, float]:
    """The serving numbers over `calls` (see the module docstring); `noise(call,
    n, bucket)` gives a call's diffusion start noise."""
    p, c, dev = ctx.params, ref.cfg, ref.device
    penalty = float(ctx.cfg["sampling"]["repetition_penalty"])
    out: Dict[str, float] = {"decode_gap": 0.0, "latent_rel": 0.0, "mel_rel": 0.0,
                             "wav_rel": 0.0}
    k = int(p["candidates"])
    if k > 1:
        out["clvp_rel"] = 0.0
    for call in calls:
        n, pick = len(call["texts"]), call["check"]
        sel = torch.as_tensor(pick, device=dev)
        ids = ref.text_ids(call["texts"])[sel]  # padded as the whole call's
        every = torch.as_tensor(np.asarray(call["codes"]), device=dev)
        cand = [t * k + j for t in pick for j in range(k)]
        served = every[torch.as_tensor(cand, device=dev)]
        text_b = ids.repeat_interleave(k, dim=0)
        prompt = ref.prompt.expand(len(cand), -1)
        g = [i for i, row in enumerate(cand) if row % int(p["greedy_stride"]) == 0]
        logits = ref.models["gpt"].decode_logits(text_b[g], prompt[g], served[g])
        seen = _seen(prompt[g], served[g], logits.shape[-1])
        pen = penalized(logits, seen, penalty)
        if control is None:
            tok = served[g]
        else:
            lc = control.models["gpt"].decode_logits(text_b[g], prompt[g], served[g])
            tok = penalized(lc, seen, penalty).argmax(-1)
        gap = pen.max(-1).values - pen.gather(-1, tok[..., None])[..., 0]
        out["decode_gap"] = max(out["decode_gap"], float(gap.max()))

        if k > 1:
            sims = ref.models["clvp"](text_b, served)
            got = (call["sims"][torch.as_tensor(cand, device=call["sims"].device)]
                   if control is None else control.models["clvp"](text_b, served)).float()
            err = float((got - sims).abs().max() / sims.abs().max().clamp_min(1e-30))
            out["clvp_rel"] = max(out["clvp_rel"], err)
        # the tail of the program's winners, as the serving entry prepares it:
        # the bucket is the whole call's
        stop = c.gpt.stop_mel_token
        lens_all = [max(int((row == stop).nonzero()[0, 0]) if bool((row == stop).any())
                        else row.shape[0], 1)
                    for row in every[torch.as_tensor(call["best"], device=dev)]]
        bucket = min(_round_up(max(lens_all), 32), every.shape[1])
        winners = every[torch.as_tensor([call["best"][t] for t in pick], device=dev)]
        lens = [lens_all[t] for t in pick]
        keep = torch.arange(winners.shape[1], device=dev)[None] < torch.as_tensor(
            lens, device=dev)[:, None]
        clean = torch.where(keep, winners, 0)[:, :bucket]
        lat_ref = ref.latent(ids, clean, lens)
        z = noise(call, n, bucket)[sel]
        mel_ref = ref.tail(lat_ref, z, int(p["diffusion_steps"]))
        prog_mel = call["mel"][sel.to(call["mel"].device)]
        wav_ref = ref.models["vocos"](prog_mel)
        if control is None:
            lat, mel = call["latent"][sel.to(call["latent"].device)], prog_mel
            wav = torch.cat([torch.as_tensor(call["wavs"][t], device=dev) for t in pick])
        else:
            lat = control.latent(ids, clean, lens)
            mel = control.tail(lat, z, int(p["diffusion_steps"]))
            wav = control.models["vocos"](prog_mel)
            wav = torch.cat([wav[i, : cl * 4 * c.vocos.hop_length] for i, cl in enumerate(lens)])
        want = torch.cat([wav_ref[i, : cl * 4 * c.vocos.hop_length] for i, cl in enumerate(lens)])
        out["latent_rel"] = max(out["latent_rel"], rel_l2(lat, lat_ref))
        out["mel_rel"] = max(out["mel_rel"], rel_l2(mel, mel_ref))
        out["wav_rel"] = max(out["wav_rel"], rel_l2(wav, want))
    return out


# ------------------------------------------------------------------ training


def leaf_gaps(got: Dict[str, float], want: Dict[str, float]) -> Dict[str, float]:
    """Each leaf's |got - want| over max(want of the leaf, median want)."""
    med = float(np.median(list(want.values())))
    return {n: abs(got[n] - want[n]) / max(v, med, 1e-30) for n, v in want.items()}


def worst(gaps: Dict[str, float], n: int = 3) -> str:
    return ", ".join(f"{k} {v:.3g}" for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:n])


class AdamW:
    """The update the configuration states, by hand: clip by the global
    norm, then AdamW (decoupled weight decay times the learning rate,
    bias-corrected moments, eps outside the root) with a linear warmup
    lr * min(1, (count + 1) / warmup)."""

    def __init__(self, params: Dict[str, torch.Tensor], train: dict):
        self.p, self.t = params, train
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Apply one update; return the clipped gradients it applied."""
        t = self.t
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        scale = float(t["grad_clip"]) / float(norm) if float(norm) >= t["grad_clip"] else 1.0
        grads = {k: g * scale for k, g in grads.items()}
        lr = t["lr"] * min(1.0, (self.count + 1) / max(t["warmup_steps"], 1))
        b1, b2 = t["betas"]
        self.count += 1
        for k, p in self.p.items():
            g = grads[k]
            p.mul_(1 - lr * t["weight_decay"])
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            mhat = self.m[k] / (1 - b1 ** self.count)
            vhat = self.v[k] / (1 - b2 ** self.count)
            p.sub_(lr * mhat / (vhat.sqrt() + t["eps"]))
        return grads


def _leaf(name: str) -> str:
    """A parameter's name without a parametrization's wrapping."""
    return name.replace("parametrizations.", "").replace(".original", "")


def reference_steps(model: torch.nn.Module, batches: List[dict], train: dict,
                    text_weight: float, mel_weight: float, block: int = 8) -> dict:
    """Three (or len(batches)) f32 steps of `model` on `batches`, each over
    blocks of `block` rows with the loss weighted by their share of the
    batch: {"losses", "grad1" (leaf norms of the first applied gradient),
    "params" (the parameters after the steps)}."""
    params = {_leaf(k): v for k, v in model.named_parameters()}
    opt = AdamW({k: v.data for k, v in params.items()}, train)
    losses, grad1 = [], None
    for batch in batches:
        b = batch["text"].shape[0]
        step = block if b % block == 0 else b
        grads = {k: torch.zeros_like(v) for k, v in params.items()}
        total = 0.0
        for s in range(0, b, step):
            part = {k: v[s: s + step] for k, v in batch.items()}
            lt, lm = model(part["text"], part["text_lengths"], part["mel_codes"],
                           part["wav_lengths"], return_latent=False)
            loss = (text_weight * lt + mel_weight * lm) * (part["text"].shape[0] / b)
            got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            for (k, _), gk in zip(params.items(), got):
                if gk is not None:
                    grads[k] += gk
            total += float(loss.detach())
        applied = opt.step(grads)
        if grad1 is None:
            grad1 = applied
        losses.append(total)
    return {"losses": losses, "grad1": {k: float(g.norm()) for k, g in grad1.items()},
            "grad1_t": grad1, "params": {k: v.detach().clone() for k, v in params.items()}}


def train_readings(prog: dict, ref: dict, start: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The training numbers from the program's first steps (`prog`: losses,
    grad1 norms, delta: each parameter's change) against the reference's
    (`ref` of reference_steps); `start` holds the parameters both began
    from."""
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    grad = leaf_gaps(prog["grad1"], ref["grad1"])
    g1 = ref["grad1_t"]
    rms = float(np.median([float(g.norm()) / g.numel() ** 0.5 for g in g1.values()]))
    got, want, left = {}, {}, {}
    for k, g in g1.items():
        keep = g.abs() >= 1e-3 * rms
        left[k] = int((~keep).sum())
        if bool(keep.any()):
            got[k] = float(prog["delta"][k][keep].float().norm())
            want[k] = float((ref["params"][k] - start[k])[keep].norm())
    change = leaf_gaps(got, want)
    most = sorted(((v / g1[k].numel(), k) for k, v in left.items() if v), reverse=True)[:4]
    print(f"worst leaves: grad {worst(grad)}; change {worst(change)}; elements left out of "
          f"the change: {sum(left.values())}, most in "
          f"{', '.join(f'{k} {s:.2f}' for s, k in most)}", file=sys.stderr)
    return {"loss_rel": loss_rel, "grad_gap": max(grad.values()),
            "change_gap": max(change.values())}
