"""Zero-shot TTS serving, port of ttts_tpu/api.py `TextToSpeech.tts`,
`tts_batch` and `tts_batch_many`:

  text → pinyin → BPE ─┐
  prompt wav → resample → VITS spectrogram → codec extract_code → prompt codes
                       → GPT AR decode of k candidates per text (KV cache,
                         fused decode attention)
                       → CLVP rerank: the best of each text's k candidates
                       → GPT return_latent of the winners
                       → AA_diffusion through the configured ODE sampler
                         (DPM-Solver++(2M) or UniPC), cond/uncond batched 2B
                       → Vocos → 24 kHz waveforms.

The presets set k and the number of diffusion steps; "fast" (4 candidates,
50 steps) is the default, as in the JAX package. Models stay resident on
`device`, the card unless the caller asks for the CPU; on a CUDA device the
GPT, diffusion and x-transformers CLVP-encoder matmul weights are stored in
bf16 (norms, heads and CLVP's pooling f32; the plain-Transformer CLVP stays
f32) and TF32 is switched off, so the codec's f32 convolutions, the VQ
search and the plain CLVP stay IEEE f32.

Under a mesh (parallel.make_mesh; the JAX package's mesh serving,
api.py:96-172) every process holds a replicated copy of the models, and:
  - a `data` (and `dcn`) axis shards the stream batch: each rank decodes,
    reranks and synthesises its rows when the rows divide over the data
    ranks, and every rank runs the whole batch otherwise, as the JAX
    package leaves such a batch unsharded; the rows are all-gathered after
    each stage, so every rank returns what the unsharded call returns;
  - a `model` axis of more than one rank runs the GPT decode tensor-
    parallel over the heads (gpt.inference_speech's `tp`);
  - an `sp` axis of more than one rank runs the diffusion trunk's attention
    as ring attention (diffusion_net's sp_mesh).
The random draws are the global batch's on every rank, from the shared
seed, and each rank takes its rows, so the sharded call draws what the
unsharded one draws.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ttts_tpu_torch.config import MLAMoEConfig, TTTSConfig, default_config
from ttts_tpu_torch.infer_utils import STAGES, load_state_dict, prepare_device
from ttts_tpu_torch.text import default_tokenizer, text_to_pinyin
from ttts_tpu_torch.diffusion import cfg_eps_fn, get_ode_sampler
from ttts_tpu_torch.models.clvp import CLVP, RMSNorm
from ttts_tpu_torch.models.diffusion_net import (
    AA_diffusion,
    denormalize_tacotron_mel,
    normalize_tacotron_mel,
)
from ttts_tpu_torch.models import mla_moe
from ttts_tpu_torch.models.gpt import UnifiedVoice, inference_speech
from ttts_tpu_torch.models.sampling import SamplingParams, sample_gumbel
from ttts_tpu_torch.models.vocos import Vocos
from ttts_tpu_torch.models.vqvae import SynthesizerTrn
from ttts_tpu_torch.ops.mel import acoustic_mel_spectrogram, vits_spectrogram
from ttts_tpu_torch.ops.resample import resample
from ttts_tpu_torch.parallel.mesh import (
    axis_group,
    axis_size,
    data_axis_size,
    gather_batch,
    replicate,
    shard_batch,
)
from ttts_tpu_torch.utils.logging import span

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
    """Store matmul weights in `dtype`; LayerNorm / GroupNorm / RMSNorm
    parameters and output heads stay f32 (ttts_tpu cast_params_for_inference)."""
    for name, m in module.named_modules():
        if isinstance(m, (nn.LayerNorm, nn.GroupNorm, RMSNorm) + mla_moe.F32_MODULES) or \
                "head" in name:
            continue
        for p in m.parameters(recurse=False):
            p.data = p.data.to(dtype)
    return module


class Draws:
    """The random draws of one `tts` / `tts_batch` call from one seeded
    torch.Generator: each decode step's Gumbel noise (steps, N*k, V) and the
    diffusion start noise (N, 4 * bucket, n_mels)."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def gumbel(self, shape) -> torch.Tensor:
        return sample_gumbel(shape, self.gen, self.device)

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, device=self.device)


class _Stages:
    """The stages of one call: each runs inside a `ttts.stage.<name>` span
    (utils.logging.span) and, when `timed`, between two CUDA events on a
    card (two readings of the host clock on the CPU), read by `times` once
    the call's own last copy to the host has synchronised. Untimed, no
    event is made."""

    def __init__(self, timed: bool, device: torch.device):
        self.marks = [] if timed else None
        self.device = device

    @contextlib.contextmanager
    def __call__(self, name: str):
        with span("ttts.stage." + name):
            if self.marks is None:
                yield
            else:
                start = self._now()
                yield
                self.marks.append((name, start, self._now()))

    def _now(self):
        if self.device.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def times(self) -> Dict[str, float]:
        """{stage: seconds} of the timed stages ({} untimed)."""
        if not self.marks:
            return {}
        if self.device.type != "cuda":
            return {name: end - start for name, start, end in self.marks}
        self.marks[-1][2].synchronize()  # recorded after the call's last copy
        return {name: start.elapsed_time(end) / 1e3 for name, start, end in self.marks}


class TextToSpeech:
    """Resident-model serving orchestrator."""

    def __init__(self, cfg: Optional[TTTSConfig] = None, device="cuda", seed: int = 0,
                 mesh=None, trunk: Optional[MLAMoEConfig] = None):
        """Random weights from `seed`; `set_params` loads a stage's weights
        (e.g. from ttts_tpu_torch.porting). `device` is the card unless the
        caller asks for the CPU; with no card, the default fails. `mesh`: a
        DeviceMesh of parallel.make_mesh (see the module docstring); every
        process of it constructs the TextToSpeech and makes the same calls.
        `trunk`: an MLAMoEConfig makes the GPT's trunk that public LLM
        block (models/mla_moe.py; UnifiedVoice's `trunk`), built on the meta
        device and made on `device` in the serving dtype (bf16 on the card,
        its norms and router f32; f32 on the CPU), so no f32 copy of it is
        ever held; it has no mesh path and raises under one."""
        self.cfg = c = cfg or default_config()
        if trunk is not None and mesh is not None:
            raise NotImplementedError("the MLA-MoE trunk has no mesh (data, tensor or "
                                      "sequence parallel) serving path")
        self.device = prepare_device(device)
        self.tok = default_tokenizer()
        self.mesh = mesh
        sp_mesh = mesh if mesh is not None and axis_size(mesh, "sp") > 1 else None
        self._tp = None if mesh is None else axis_group(mesh, "model")
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.codec = SynthesizerTrn(c.vqvae, spec_channels=c.audio.filter_length // 2 + 1)
            if trunk is None:
                self.gpt = UnifiedVoice(c.gpt)
            else:
                with torch.device("meta"):
                    self.gpt = UnifiedVoice(c.gpt, trunk=trunk)
                dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
                mla_moe.materialize(self.gpt, self.device, dtype, seed)
            self.diffusion = AA_diffusion(c.diffusion_net, sp_mesh=sp_mesh)
            self.vocos = Vocos(c.vocos)
            self.clvp = CLVP(c.clvp)
        for m in self._modules().values():
            m.eval().requires_grad_(False).to(self.device)
            if mesh is not None:
                replicate(m, mesh)
        if self.device.type == "cuda":
            # the plain-Transformer CLVP stays f32, as the JAX package serves it
            clvp = ((self.clvp.text_transformer, self.clvp.speech_transformer)
                    if c.clvp.use_xformers else ())
            for m in (self.gpt, self.diffusion) + clvp:
                cast_for_inference(m)
        self._cond_cache: Dict[str, tuple] = {}
        # when True, each call times its stages (_Stages: CUDA events, no
        # synchronise) into last_stage_times, seconds a stage
        self.profile_stages = False
        self.last_stage_times: Dict[str, float] = {}
        # the last call's draw: every candidate's codes (N*k, max_gen), the
        # winning row of each text and each winner's code length
        self.last_codes = np.zeros((0, 0), np.int64)
        self.last_best: List[int] = []
        self.last_code_lens: List[int] = []

    @classmethod
    def from_checkpoints(cls, cfg: Optional[TTTSConfig] = None, *, codec=None, gpt=None,
                         diffusion=None, vocos=None, clvp=None, device="cuda",
                         seed: int = 0, mesh=None) -> "TextToSpeech":
        """Serving from trained weights (ttts_tpu TextToSpeech.from_checkpoints):
        each stage argument is a release `.npz` of export_release
        (infer_utils.load_state_dict); a stage left None keeps its random
        weights from `seed`. Orbax directories raise: the JAX package reads
        them. `mesh` as in __init__ (every process reads the same files)."""
        tts = cls(cfg, device=device, seed=seed, mesh=mesh)
        paths = {"codec": codec, "gpt": gpt, "diffusion": diffusion, "vocos": vocos,
                 "clvp": clvp}
        for name, stage in STAGES.items():
            if paths.get(stage) is not None:
                tts.set_params(stage, load_state_dict(name, paths[stage]))
        return tts

    def _modules(self) -> Dict[str, nn.Module]:
        return {"codec": self.codec, "gpt": self.gpt, "diffusion": self.diffusion,
                "vocos": self.vocos, "clvp": self.clvp}

    def set_params(self, stage: str, state_dict) -> None:
        """Load a stage's weights (arrays under the module's state-dict keys,
        e.g. from ttts_tpu_torch.porting); values convert to the stored
        dtypes. New codec weights drop the cached conditioning."""
        sd = {k: torch.as_tensor(np.asarray(v)) for k, v in state_dict.items()}
        self._modules()[stage].load_state_dict(sd, strict=True)
        if stage == "codec":
            self._cond_cache.clear()

    # ------------------------------------------------------------------ mesh

    def _sharded(self, b: int) -> bool:
        """Whether a stream batch of `b` rows shards over the data ranks
        (_shard_stream_batch, api.py:161-172): a mesh with more than one
        data rank that divides b."""
        if self.mesh is None:
            return False
        n = data_axis_size(self.mesh)
        return n > 1 and b % n == 0

    def _local(self, x: torch.Tensor, b: int, dim: int = 0) -> torch.Tensor:
        """This rank's rows (along `dim`) of a global batch of `b` rows."""
        return shard_batch(self.mesh, x, dim) if self._sharded(b) else x

    def _whole(self, x: torch.Tensor, b: int) -> torch.Tensor:
        """The global batch of `b` rows from every rank's local rows."""
        return gather_batch(self.mesh, x) if self._sharded(b) else x

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

    def tts(self, text: str, voice_wav: np.ndarray, voice_sample_rate: int,
            preset: str = "fast", max_generate_length: int = 400, seed: int = 0,
            voice_cache_key: Optional[str] = None, draws: Optional[Draws] = None) -> np.ndarray:
        """Full zero-shot synthesis → 24 kHz float waveform: `tts_batch` of
        one text (the JAX package's tts computes the same)."""
        return self.tts_batch([text], voice_wav, voice_sample_rate, preset,
                              max_generate_length, seed, voice_cache_key, draws)[0]

    @torch.no_grad()
    def tts_batch(self, texts: Sequence[str], voice_wav: np.ndarray, voice_sample_rate: int,
                  preset: str = "fast", max_generate_length: int = 400, seed: int = 0,
                  voice_cache_key: Optional[str] = None,
                  draws: Optional[Draws] = None) -> List[np.ndarray]:
        """Batched streams: several texts against one voice in one GPT batch
        of N*k rows (each text repeated k times, in order), one CLVP rerank
        (argmax inside each block of k), one tail batch bucketed by the
        longest winner, each waveform trimmed to its own code length.
        `draws` overrides the random draws (default: Draws(seed, device))."""
        return self._tts_batch(
            texts, lambda: self.get_conditioning(voice_wav, voice_sample_rate, voice_cache_key),
            preset, max_generate_length, draws or Draws(seed, self.device))

    def _tts_batch(self, texts: Sequence[str], conditioning: Callable[[], tuple], preset: str,
                   max_generate_length: int, draws: Draws) -> List[np.ndarray]:
        """tts_batch with the voice's conditioning from `conditioning()`
        (get_conditioning's output). The stages, in this order, tile the
        call: conditioning, gpt_decode, clvp_rerank, select, tail's three,
        to_host."""
        opts = PRESETS[preset]
        k, n = opts["num_autoregressive_samples"], len(texts)
        c, dev = self.cfg, self.device
        stage = _Stages(self.profile_stages, dev)

        with stage("conditioning"):
            prompt_codes, refer_mel = conditioning()
            ids = [np.asarray(self.tok.encode(text_to_pinyin(t)), np.int64) for t in texts]
            lt = _round_up(max(len(i) for i in ids), 16)
            text_ids = torch.as_tensor(np.stack([np.pad(i, (0, lt - len(i))) for i in ids]),
                                       device=dev)
            lp = _round_up(prompt_codes.shape[1], 16)
            prompt_codes = torch.nn.functional.pad(prompt_codes,
                                                   (0, lp - prompt_codes.shape[1]))

        rows = n * k
        with stage("gpt_decode"):
            text_b = text_ids.repeat_interleave(k, dim=0)
            # the global batch's draws on every rank; each rank takes its rows
            gumbel = draws.gumbel((max_generate_length, rows, c.gpt.number_mel_codes))
            codes = inference_speech(
                self.gpt, self._local(text_b, rows),
                self._local(prompt_codes.expand(rows, -1), rows), max_generate_length,
                SamplingParams(top_p=0.8, temperature=0.8, repetition_penalty=2.0),
                self._local(gumbel, rows, 1), self._tp)
            codes = self._whole(codes, rows)
        with stage("clvp_rerank"):
            if k > 1:
                sims = self.clvp(self._local(text_b, rows), self._local(codes, rows))
                sims = self._whole(sims, rows).reshape(n, k)
                best = (sims.argmax(dim=1) + torch.arange(n, device=dev) * k).tolist()
            else:
                best = list(range(n))

        with stage("select"):
            arr = codes.cpu().numpy()
            code_lens = []
            for row in arr[best]:
                stops = np.where(row == c.gpt.stop_mel_token)[0]
                code_lens.append(max(int(stops[0]) if len(stops) else row.shape[0], 1))
            bucket = code_bucket(max(code_lens), arr.shape[1])
            clean = np.stack([np.where(np.arange(arr.shape[1]) < cl, row, 0)[:bucket]
                              for row, cl in zip(arr[best], code_lens)])
            noise = draws.normal((n, bucket * 4, c.diffusion_net.in_channels))
            mine = self._local(torch.arange(n), n).tolist()
            tail_in = (self._local(text_ids, n),
                       self._local(torch.as_tensor(clean, device=dev), n),
                       [code_lens[i] for i in mine], refer_mel, self._local(noise, n))
        _, wav = self.tail(*tail_in, opts["diffusion_iterations"], stage)

        with stage("to_host"):
            # exact audio = code_len x 4 mel frames x hop samples (Vocos yields
            # (frames - 1) x hop, so a full bucket comes out one hop short)
            wav = self._whole(wav, n).cpu().numpy()
            hop = c.vocos.hop_length
            out = [wav[i, : cl * 4 * hop] for i, cl in enumerate(code_lens)]
        self.last_stage_times = stage.times()
        self.last_codes, self.last_best, self.last_code_lens = arr, best, code_lens
        return out

    @torch.no_grad()
    def tts_batch_many(self, batches: Sequence[Sequence[str]], voice_wav: np.ndarray,
                       voice_sample_rate: int, preset: str = "fast",
                       max_generate_length: int = 400, seed: int = 0,
                       voice_cache_key: Optional[str] = None) -> List[List[np.ndarray]]:
        """Sustained serving over a stream of request batches: batch i is
        `tts_batch` with seed `seed + i`, the JAX package's contract. The
        voice's conditioning runs once per call, as in the JAX package; the
        batches run one after another. Overlapping batch i+1's decode with
        batch i's tail, as the JAX package does, waits for a decode loop
        captured in CUDA graphs."""
        conditioning = self.get_conditioning(voice_wav, voice_sample_rate, voice_cache_key)
        return [self._tts_batch(texts, lambda: conditioning, preset, max_generate_length,
                                Draws(seed + i, self.device))
                for i, texts in enumerate(batches)]

    @torch.no_grad()
    def tail(self, text_ids, codes, code_lens: Sequence[int], refer_mel, noise, steps: int,
             stage: Optional[_Stages] = None):
        """GPT latent → diffusion → Vocos for drawn codes (N, bucket), row i
        zero past `code_lens[i]`; `refer_mel` (1, Tr, n_mels) serves every
        row; `noise` (N, 4 * bucket, n_mels) starts the sampler. Returns
        (mel (N, 4 * bucket, n_mels), waveform (N, L)). `stage`: the call's
        _Stages (untimed spans by default)."""
        c, dev, net = self.cfg, self.device, self.diffusion
        stage = stage or _Stages(False, dev)
        b = codes.shape[0]
        with stage("latent_and_cond"):
            latent = self.gpt(text_ids, torch.full((b,), text_ids.shape[1], device=dev), codes,
                              torch.as_tensor(code_lens, device=dev) * 1024, return_latent=True)
            out_len = codes.shape[1] * 4
            refer = normalize_tacotron_mel(refer_mel).expand(b, -1, -1)
            cond = net.timestep_independent(latent, refer, out_len)
            strips = net.rel_biases(out_len)
            eps_fn = cfg_eps_fn(lambda x2, t2, e2: net.trunk(x2, t2, e2, strips), cond,
                                net.unconditioned(b, out_len), c.diffusion.cond_free_k)
        with stage("diffusion"):
            mel = denormalize_tacotron_mel(
                get_ode_sampler(c.diffusion.sampler)(eps_fn, noise, steps=steps))
        with stage("vocos"):
            wav = self.vocos(mel)
        return mel, wav
