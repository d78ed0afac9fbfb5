"""Zero-shot TTS serving, port of ttts_tpu/api.py `TextToSpeech.tts`:

  text → pinyin → BPE ─┐
  prompt wav → resample → VITS spectrogram → codec extract_code → prompt codes
                       → GPT AR decode (KV cache, fused decode attention)
                       → GPT return_latent of the drawn codes
                       → AA_diffusion DPM-Solver++(2M), cond/uncond batched 2B
                       → Vocos → 24 kHz waveform.

Only one candidate per text is drawn (preset "ultra_fast"): the CLVP rerank
of the other presets is not ported yet. Models stay resident on `device`;
on a CUDA device the GPT and diffusion matmul weights are stored in bf16
(norms and heads f32) and TF32 is switched off, so the codec's f32
convolutions and the VQ search stay IEEE f32.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from ttts_tpu.config import TTTSConfig, default_config
from ttts_tpu.text import default_tokenizer, text_to_pinyin
from ttts_tpu_torch.diffusion import cfg_eps_fn, get_ode_sampler
from ttts_tpu_torch.models.diffusion_net import (
    AA_diffusion,
    denormalize_tacotron_mel,
    normalize_tacotron_mel,
)
from ttts_tpu_torch.models.gpt import UnifiedVoice, inference_speech
from ttts_tpu_torch.models.sampling import SamplingParams, sample_gumbel
from ttts_tpu_torch.models.vocos import Vocos
from ttts_tpu_torch.models.vqvae import SynthesizerTrn
from ttts_tpu_torch.ops.mel import acoustic_mel_spectrogram, vits_spectrogram
from ttts_tpu_torch.ops.resample import resample

PRESETS = {
    "ultra_fast": {"num_autoregressive_samples": 1, "diffusion_iterations": 30},
    "fast": {"num_autoregressive_samples": 4, "diffusion_iterations": 50},
    "standard": {"num_autoregressive_samples": 8, "diffusion_iterations": 50},
    "high_quality": {"num_autoregressive_samples": 16, "diffusion_iterations": 100},
}


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def code_bucket(code_len: int, cap: int) -> int:
    """Mel-code bucket of the diffusion/vocoder tail: round up to 32."""
    return min(_round_up(code_len, 32), cap)


def cast_for_inference(module: nn.Module, dtype=torch.bfloat16) -> nn.Module:
    """Store matmul weights in `dtype`; LayerNorm / GroupNorm parameters and
    output heads stay f32 (ttts_tpu cast_params_for_inference)."""
    for name, m in module.named_modules():
        if isinstance(m, (nn.LayerNorm, nn.GroupNorm)) or "head" in name:
            continue
        for p in m.parameters(recurse=False):
            p.data = p.data.to(dtype)
    return module


class Draws:
    """The random draws of one `tts` call: each decode step's Gumbel noise
    and the diffusion start noise, from one seeded torch.Generator."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def gumbel(self, shape) -> torch.Tensor:
        return sample_gumbel(shape, self.gen, self.device)

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, device=self.device)


class TextToSpeech:
    """Resident-model serving orchestrator."""

    def __init__(self, cfg: Optional[TTTSConfig] = None, device="cpu", seed: int = 0):
        """Random weights from `seed`; `set_params` loads a stage's weights
        (e.g. from ttts_tpu_torch.porting)."""
        self.cfg = c = cfg or default_config()
        self.device = torch.device(device)
        self.tok = default_tokenizer()
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.codec = SynthesizerTrn(c.vqvae, spec_channels=c.audio.filter_length // 2 + 1)
            self.gpt = UnifiedVoice(c.gpt)
            self.diffusion = AA_diffusion(c.diffusion_net)
            self.vocos = Vocos(c.vocos)
        for m in self._modules().values():
            m.eval().requires_grad_(False).to(self.device)
        if self.device.type == "cuda":
            cast_for_inference(self.gpt)
            cast_for_inference(self.diffusion)
        self._cond_cache: Dict[str, tuple] = {}
        # when True, tts synchronises after each stage and records wall times
        # (perf analysis only: the syncs serialise host and device)
        self.profile_stages = False
        self.last_stage_times: Dict[str, float] = {}
        self.last_codes = np.zeros((0,), np.int64)  # the last tts call's drawn codes

    def _modules(self) -> Dict[str, nn.Module]:
        return {"codec": self.codec, "gpt": self.gpt, "diffusion": self.diffusion,
                "vocos": self.vocos}

    def set_params(self, stage: str, state_dict) -> None:
        """Load a stage's weights (arrays under the module's state-dict keys,
        e.g. from ttts_tpu_torch.porting); values convert to the stored
        dtypes. New codec weights drop the cached conditioning."""
        sd = {k: torch.as_tensor(np.asarray(v)) for k, v in state_dict.items()}
        self._modules()[stage].load_state_dict(sd, strict=True)
        if stage == "codec":
            self._cond_cache.clear()

    # ---------------------------------------------------------- conditioning

    @torch.no_grad()
    def get_conditioning(self, voice_wav: np.ndarray, sample_rate: int,
                         cache_key: Optional[str] = None):
        """prompt wav → (prompt VQ codes (1, Lp), reference mel (1, Tr, 100))."""
        if cache_key and cache_key in self._cond_cache:
            return self._cond_cache[cache_key]
        c = self.cfg
        wav = torch.as_tensor(np.asarray(voice_wav, np.float32).reshape(1, -1),
                              device=self.device)
        wav32 = resample(wav, sample_rate, c.audio.sampling_rate)
        hop = c.audio.hop_length
        wav32 = wav32[:, : (wav32.shape[1] // hop) * hop]
        spec = vits_spectrogram(wav32, c.audio.filter_length, hop,
                                c.audio.win_length).transpose(1, 2)
        lengths = torch.tensor([spec.shape[1]], device=self.device)
        codes = self.codec.extract_code(wav32[..., None], spec, lengths)
        wav24 = resample(wav, sample_rate, c.acoustic_mel.sample_rate)
        refer_mel = acoustic_mel_spectrogram(
            wav24, c.acoustic_mel.sample_rate, c.acoustic_mel.n_fft,
            c.acoustic_mel.hop_length, c.acoustic_mel.n_mels).transpose(1, 2)
        out = (codes[:, 0, :], refer_mel)
        if cache_key:
            self._cond_cache[cache_key] = out
        return out

    # ------------------------------------------------------------------ tts

    def _mark(self, times: Optional[Dict[str, float]], name: str, t0: float) -> float:
        if times is None or not self.profile_stages:
            return t0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        times[name] = now - t0
        return now

    @torch.no_grad()
    def tts(self, text: str, voice_wav: np.ndarray, voice_sample_rate: int,
            preset: str = "ultra_fast", max_generate_length: int = 400, seed: int = 0,
            voice_cache_key: Optional[str] = None, draws: Optional[Draws] = None) -> np.ndarray:
        """Full zero-shot synthesis → 24 kHz float waveform. `draws` overrides
        the random draws (default: Draws(seed, device))."""
        opts = PRESETS[preset]
        if opts["num_autoregressive_samples"] != 1:
            raise NotImplementedError(
                f"preset {preset!r} draws several candidates; the CLVP rerank that "
                "picks one is not ported yet (use preset='ultra_fast')")
        c, dev = self.cfg, self.device
        draws = draws or Draws(seed, dev)
        times: Dict[str, float] = {}
        t0 = time.perf_counter()

        ids = np.asarray(self.tok.encode(text_to_pinyin(text)), np.int64)
        lt = _round_up(len(ids), 16)
        text_ids = torch.as_tensor(np.pad(ids, (0, lt - len(ids))), device=dev)[None]
        prompt_codes, refer_mel = self.get_conditioning(voice_wav, voice_sample_rate,
                                                        voice_cache_key)
        lp = _round_up(prompt_codes.shape[1], 16)
        prompt_codes = torch.nn.functional.pad(prompt_codes, (0, lp - prompt_codes.shape[1]))
        t0 = self._mark(times, "conditioning", t0)

        gumbel = draws.gumbel((max_generate_length, 1, c.gpt.number_mel_codes))
        codes = inference_speech(
            self.gpt, text_ids, prompt_codes, max_generate_length,
            SamplingParams(top_p=0.8, temperature=0.8, repetition_penalty=2.0), gumbel)
        arr = codes[0].cpu().numpy()
        stops = np.where(arr == c.gpt.stop_mel_token)[0]
        code_len = max(int(stops[0]) if len(stops) else arr.shape[0], 1)
        bucket = code_bucket(code_len, arr.shape[0])
        clean = np.where(np.arange(arr.shape[0]) < code_len, arr, 0)[:bucket]
        self._mark(times, "gpt_decode", t0)

        noise = draws.normal((1, bucket * 4, c.diffusion_net.in_channels))
        _, wav = self.tail(text_ids, torch.as_tensor(clean, device=dev)[None], code_len,
                           refer_mel, noise, opts["diffusion_iterations"], times)
        # exact audio = code_len x 4 mel frames x hop samples (Vocos yields
        # (frames - 1) x hop, so a full bucket comes out one hop short)
        self.last_stage_times = times
        self.last_codes = arr[:code_len]
        return wav[0, : code_len * 4 * c.vocos.hop_length].cpu().numpy()

    @torch.no_grad()
    def tail(self, text_ids, codes, code_len: int, refer_mel, noise, steps: int,
             times: Optional[Dict[str, float]] = None):
        """GPT latent → diffusion → Vocos for drawn codes (1, bucket), zero
        past `code_len`; `noise` (1, 4 * bucket, n_mels) starts the sampler.
        Returns (mel (1, 4 * bucket, n_mels), waveform (1, L))."""
        c, dev, net = self.cfg, self.device, self.diffusion
        t0 = time.perf_counter()
        latent = self.gpt(text_ids, torch.tensor([text_ids.shape[1]], device=dev), codes,
                          torch.tensor([code_len * 1024], device=dev), return_latent=True)
        out_len = codes.shape[1] * 4
        cond = net.timestep_independent(latent, normalize_tacotron_mel(refer_mel), out_len)
        strips = net.rel_biases(out_len)
        eps_fn = cfg_eps_fn(lambda x2, t2, e2: net.trunk(x2, t2, e2, strips), cond,
                            net.unconditioned(1, out_len), c.diffusion.cond_free_k)
        t0 = self._mark(times, "latent_and_cond", t0)
        mel = denormalize_tacotron_mel(
            get_ode_sampler(c.diffusion.sampler)(eps_fn, noise, steps=steps))
        t0 = self._mark(times, "diffusion", t0)
        wav = self.vocos(mel)
        self._mark(times, "vocos", t0)
        return mel, wav
