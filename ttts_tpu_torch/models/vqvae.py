"""The codec, port of ttts_tpu/models/vqvae.py SynthesizerTrn: its extract
path (`extract_code`: ref_enc (MelStyleEncoder), enc_p
(PosteriorAudioEncoder), the stride-2 proj and the RVQ codebook), its
synthesis half (`infer`, codec reconstruction, and `decode`, codes + text +
reference spectrogram → wav: enc_p_2 (TextEncoder with MRTE), the coupling
flow's reverse pass and the HiFi-GAN generator dec) and, built with
`for_training=True`, its training forward (`forward`, JAX's `__call__`: the
posterior enc_q, the flow, the EMA / k-means codebook update and the
decoder on random slices). Release checkpoints drop enc_q, and a serving
model does not build it. State-dict keys are the reference's
(ttts/vqvae/vq2.py).

The quantizer's nearest-code search runs the VQ kernel on the card
(models/quantize.nearest); the convolutions are cuDNN, which the caller
keeps out of TF32 (api.py), as the JAX package leaves them to XLA."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ttts_tpu_torch.config import VQVAEConfig
from ttts_tpu_torch.models.blocks import (
    LRELU_SLOPE,
    AntiAliasedActivation,
    Conv1d,
    ConvTranspose1d,
    MelStyleEncoder,
    MultiHeadAttention,
    ResBlock1,
    TransformerEncoder,
    WN,
    sequence_mask,
)
from ttts_tpu_torch.models.quantize import (
    RVQState,
    rvq_decode,
    rvq_encode,
    rvq_forward,
    rvq_init,
    rvq_quantize,
)


class PosteriorAudioEncoder(nn.Module):
    """Raw-audio downsample stack with HiFi-GAN ResBlocks and an anti-aliased
    SnakeBeta, concatenated with a WN encoding of the spectrogram
    (vq2.py:667-750)."""

    def __init__(self, in_channels: int, out_channels: int, hidden_channels: int,
                 kernel_size: int = 5, dilation_rate: int = 1, n_layers: int = 16,
                 gin_channels: int = 0,
                 down_rates: Sequence[int] = (10, 8, 2, 2, 2),
                 down_kernels: Sequence[int] = (16, 16, 8, 2, 2),
                 down_channels: Sequence[int] = (16, 32, 64, 96, 128, 192),
                 rb_kernels: Sequence[int] = (3, 7, 11),
                 rb_dils: Sequence[Sequence[int]] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))):
        super().__init__()
        ch = down_channels
        self.n_rb = len(rb_kernels)
        self.down_pre = Conv1d(1, ch[0], 7)
        self.downs = nn.ModuleList(
            Conv1d(ch[i], ch[i + 1], k, stride=u, padding=((k - 1) // 2, (k - 1) // 2),
                   weight_norm=True)
            for i, (u, k) in enumerate(zip(down_rates, down_kernels)))
        self.resblocks = nn.ModuleList(
            ResBlock1(ch[i + 1], kk, dd)
            for i in range(len(down_rates)) for kk, dd in zip(rb_kernels, rb_dils))
        self.activation_post = AntiAliasedActivation(ch[-1])
        self.conv_post = Conv1d(ch[-1], hidden_channels, 7)
        self.pre = Conv1d(in_channels, hidden_channels, 1, padding=(0, 0))
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers, gin_channels)
        self.proj = Conv1d(2 * hidden_channels, 2 * out_channels, 1, padding=(0, 0))

    def forward(self, spec, audio, x_mask, g=None, noise: Optional[torch.Tensor] = None):
        """→ (z, m, logs), (B, T, out_channels) each: z = (m + noise *
        exp(logs)) * x_mask, or m * x_mask without noise."""
        a = self.down_pre(audio)
        for i, down in enumerate(self.downs):
            a = down(a)
            rbs = self.resblocks[i * self.n_rb: (i + 1) * self.n_rb]
            a = sum(rb(a) for rb in rbs) / self.n_rb
        a = self.conv_post(self.activation_post(a))
        x = self.pre(spec) * x_mask
        x = self.enc(x, x_mask, g=g)
        x = torch.cat([x, a * x_mask], dim=-1)
        stats = self.proj(x) * x_mask
        m, logs = stats.chunk(2, dim=-1)
        if noise is None:
            return m * x_mask, m, logs
        return (m + noise * torch.exp(logs)) * x_mask, m, logs


class _Codebook(nn.Module):
    """EnCodec EuclideanCodebook buffers (embed, embed_avg, cluster_size,
    inited); serving reads `embed` only."""

    def __init__(self, bins: int, dim: int):
        super().__init__()
        embed = torch.randn(bins, dim)
        self.register_buffer("embed", embed)
        self.register_buffer("embed_avg", embed.clone())
        self.register_buffer("cluster_size", torch.ones(bins))
        self.register_buffer("inited", torch.ones(1))


class ResidualVQ(nn.Module):
    """Keys quantizer.vq.layers.{i}._codebook.*; the codebook buffers are
    rvq_forward's state, updated in place by a training forward.
    `kmeans_pending`: the buffers start from rvq_init's state."""

    def __init__(self, dim: int, n_q: int = 1, bins: int = 1024, decay: float = 0.99,
                 kmeans_seeding: str = "farthest_point", kmeans_pending: bool = False):
        super().__init__()
        self.decay, self.kmeans_seeding = decay, kmeans_seeding
        self.vq = nn.Module()
        self.vq.layers = nn.ModuleList(nn.Module() for _ in range(n_q))
        for layer in self.vq.layers:
            layer._codebook = _Codebook(bins, dim)
        if kmeans_pending:
            self.set_state(rvq_init(n_q, bins, dim))

    def _embed(self) -> torch.Tensor:
        return torch.stack([layer._codebook.embed for layer in self.vq.layers])

    def state(self) -> RVQState:
        cbs = [layer._codebook for layer in self.vq.layers]
        return RVQState(embed=torch.stack([c.embed for c in cbs]),
                        embed_avg=torch.stack([c.embed_avg for c in cbs]),
                        cluster_size=torch.stack([c.cluster_size for c in cbs]),
                        inited=cbs[0].inited[0] > 0)

    @torch.no_grad()
    def set_state(self, st: RVQState) -> None:
        for i, layer in enumerate(self.vq.layers):
            cb = layer._codebook
            cb.embed.copy_(st.embed[i])
            cb.embed_avg.copy_(st.embed_avg[i])
            cb.cluster_size.copy_(st.cluster_size[i])
            cb.inited.fill_(float(bool(st.inited)))

    def forward(self, x):
        """The eval forward: x (B, T, D) → (quantized (B, T, D), codes (n_q, B, T))."""
        return rvq_quantize(self._embed(), x)

    def forward_train(self, x, draws=None, generator: Optional[torch.Generator] = None,
                      mesh=None):
        """The training forward (rvq_forward): x (B, T, D) →
        (quantized (B, T, D) through the straight-through estimator, codes
        (n_q, B, T), commit loss); the buffers take the updated codebook.
        `mesh`: x is this rank's rows of a data-parallel batch."""
        q, codes, loss, st = rvq_forward(self.state(), x, draws=draws, decay=self.decay,
                                         kmeans_seeding=self.kmeans_seeding,
                                         generator=generator, mesh=mesh)
        self.set_state(st)
        return q, codes, loss

    def encode(self, x):
        """x (B, T, D) → codes (n_q, B, T)."""
        return rvq_encode(self._embed(), x)

    def decode(self, codes):
        """codes (n_q, B, T) → (B, T, D)."""
        return rvq_decode(self._embed(), codes)


class MRTE(nn.Module):
    """Multi-reference timbre encoder: cross-attention from content frames
    to text, plus the global style (vq2.py:17-48; keys c_pre, text_pre,
    cross_attention, c_post)."""

    def __init__(self, content_channels: int, hidden_size: int = 512,
                 out_channels: int = 192, n_heads: int = 4):
        super().__init__()
        self.c_pre = Conv1d(content_channels, hidden_size, 1, padding=(0, 0))
        self.text_pre = Conv1d(content_channels, hidden_size, 1, padding=(0, 0))
        self.cross_attention = MultiHeadAttention(hidden_size, hidden_size, n_heads)
        self.c_post = Conv1d(hidden_size, out_channels, 1, padding=(0, 0))

    def forward(self, ssl_enc, ssl_mask, text, text_mask, ge):
        attn_mask = ssl_mask[:, None, :, 0][:, :, :, None] * text_mask[:, None, :, 0][:, :, None, :]
        ssl = self.c_pre(ssl_enc * ssl_mask)
        txt = self.text_pre(text * text_mask)
        x = self.cross_attention(ssl * ssl_mask, txt * text_mask, attn_mask) + ssl + ge[:, None, :]
        return self.c_post(x * ssl_mask)


class TextEncoder(nn.Module):
    """Quantized-content + text prior encoder, enc_p_2 (vq2.py:95-162):
    content and text each through a windowed transformer, MRTE, a second
    transformer, then the (m, logs) projection."""

    def __init__(self, out_channels: int, hidden_channels: int, filter_channels: int,
                 n_heads: int, n_layers: int, kernel_size: int, n_text_tokens: int = 256,
                 mrte_hidden: int = 512, p_dropout: float = 0.0):
        super().__init__()
        enc = lambda n: TransformerEncoder(  # noqa: E731
            hidden_channels, filter_channels, n_heads, n, kernel_size, p_dropout=p_dropout)
        self.encoder_ssl = enc(n_layers // 2)
        self.text_embedding = nn.Embedding(n_text_tokens, hidden_channels)
        self.encoder_text = enc(n_layers)
        self.mrte = MRTE(hidden_channels, hidden_size=mrte_hidden, out_channels=hidden_channels)
        self.encoder2 = enc(n_layers // 2)
        self.proj = Conv1d(hidden_channels, 2 * out_channels, 1, padding=(0, 0))

    def forward(self, y, y_mask, text, text_mask, ge):
        """y (B, T, hidden), text (B, L) ids, masks (B, ·, 1), ge (B, gin) →
        (y, m, logs)."""
        y = self.encoder_ssl(y * y_mask, y_mask)
        t = self.encoder_text(self.text_embedding(text) * text_mask, text_mask)
        y = self.mrte(y, y_mask, t, text_mask, ge)
        y = self.encoder2(y * y_mask, y_mask)
        m, logs = (self.proj(y) * y_mask).chunk(2, dim=-1)
        return y, m, logs


class ResidualCouplingLayer(nn.Module):
    """Mean-only affine coupling with a WN conditioner
    (modules.ResidualCouplingLayer; keys pre, enc, post: post is a 1x1 conv
    in the reference, a Dense in the JAX package)."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, gin_channels: int = 0):
        super().__init__()
        half = channels // 2
        self.pre = Conv1d(half, hidden_channels, 1, padding=(0, 0))
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers, gin_channels)
        self.post = Conv1d(hidden_channels, half, 1, padding=(0, 0))

    def forward(self, x, x_mask, g=None, reverse: bool = False):
        x0, x1 = x.chunk(2, dim=-1)
        h = self.enc(self.pre(x0) * x_mask, x_mask, g=g)
        m = self.post(h) * x_mask
        x1 = (x1 - m) * x_mask if reverse else (m + x1) * x_mask
        return torch.cat([x0, x1], dim=-1)


class Flip(nn.Module):
    """Reverse the channel order (modules.Flip; no parameters)."""

    def forward(self, x, *args, **kwargs):
        return torch.flip(x, dims=(-1,))


class ResidualCouplingBlock(nn.Module):
    """n_flows x (coupling, flip), the codec's `flow` (vq2.py:210-252; keys
    flows.{2i} the couplings, flows.{2i+1} the flips)."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, n_flows: int = 4, gin_channels: int = 0):
        super().__init__()
        self.flows = nn.ModuleList()
        for _ in range(n_flows):
            self.flows.append(ResidualCouplingLayer(channels, hidden_channels, kernel_size,
                                                    dilation_rate, n_layers, gin_channels))
            self.flows.append(Flip())

    def forward(self, x, x_mask, g=None, reverse: bool = False):
        pairs = list(zip(self.flows[0::2], self.flows[1::2]))
        if not reverse:
            for layer, flip in pairs:
                x = flip(layer(x, x_mask, g=g))
        else:
            for layer, flip in reversed(pairs):
                x = layer(flip(x), x_mask, g=g, reverse=True)
        return x


class Generator(nn.Module):
    """HiFi-GAN generator, the codec's `dec` (vq2.py:341-415): conv_pre (+
    cond of the style), then per upsample leaky ReLU (slope 0.1) → ups.{i}
    → the mean of the ResBlock1 bank, then leaky ReLU at slope 0.01 (the
    JAX package's nn.leaky_relu default) → conv_post (no bias) → tanh.
    (B, T, C) → (B, T * prod(upsample_rates), 1)."""

    def __init__(self, initial_channel: int, resblock_kernel_sizes: Sequence[int],
                 resblock_dilation_sizes: Sequence[Sequence[int]],
                 upsample_rates: Sequence[int], upsample_initial_channel: int,
                 upsample_kernel_sizes: Sequence[int], gin_channels: int = 0):
        super().__init__()
        uic = upsample_initial_channel
        self.n_rb = len(resblock_kernel_sizes)
        self.conv_pre = Conv1d(initial_channel, uic, 7)
        if gin_channels:
            self.cond = Conv1d(gin_channels, uic, 1, padding=(0, 0))
        self.ups = nn.ModuleList(
            ConvTranspose1d(uic // 2 ** i, uic // 2 ** (i + 1), k, u, padding=(k - u) // 2,
                            weight_norm=True)
            for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)))
        self.resblocks = nn.ModuleList(
            ResBlock1(uic // 2 ** (i + 1), kk, dd)
            for i in range(len(upsample_rates))
            for kk, dd in zip(resblock_kernel_sizes, resblock_dilation_sizes))
        self.conv_post = Conv1d(uic // 2 ** len(upsample_rates), 1, 7, bias=False)

    def forward(self, x, g=None):
        x = self.conv_pre(x)
        if g is not None:
            x = x + self.cond(g[:, None, :])
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            rbs = self.resblocks[i * self.n_rb: (i + 1) * self.n_rb]
            x = sum(rb(x) for rb in rbs) / self.n_rb
        return torch.tanh(self.conv_post(F.leaky_relu(x, 0.01)))


def rand_slice_segments(x: torch.Tensor, lengths: torch.Tensor, segment_frames: int,
                        ids: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random fixed-size slices (commons.rand_slice_segments): x (B, T, C)
    → (x[b, ids_b : ids_b + segment_frames], ids), ids = floor(u * (max(len
    - segment_frames, 0) + 1)) with u uniform (drawn from `generator` when
    `ids` is None)."""
    if ids is None:
        u = torch.rand(x.shape[0], generator=generator).to(x.device)
        ids = (u * ((lengths - segment_frames).clamp_min(0) + 1)).long()
    return slice_segments(x, ids, segment_frames), ids


def slice_segments(x: torch.Tensor, ids: torch.Tensor, segment_frames: int) -> torch.Tensor:
    """x (B, T, C) → x[b, ids_b : ids_b + segment_frames], each start
    clamped into [0, T - segment_frames] as jax.lax.dynamic_slice clamps."""
    if segment_frames > x.shape[1]:
        raise ValueError(f"a slice of {segment_frames} frames of {x.shape[1]}")
    start = ids.to(x.device).long().clamp(0, x.shape[1] - segment_frames)
    idx = start[:, None] + torch.arange(segment_frames, device=x.device)[None]
    return x.gather(1, idx[..., None].expand(-1, -1, x.shape[2]))


class SynthesizerTrn(nn.Module):
    """The codec (vq2.py:749). Channels-last: spec (B, T, spec_channels),
    wav (B, T*hop, 1), text (B, L) ids. A serving model leaves enc_q out;
    `for_training=True` builds enc_q and a codebook waiting for its k-means
    init (rvq_init), as JAX's training init has it. The two share every
    other parameter and its layout, so a trained state dict without enc_q
    loads into a serving model as it is."""

    def __init__(self, cfg: VQVAEConfig, spec_channels: int = 1025, segment_frames: int = 32,
                 for_training: bool = False):
        super().__init__()
        c = self.cfg = cfg
        self.segment_frames = segment_frames  # 20480 samples / 640 hop
        self.ref_enc = MelStyleEncoder(n_mel_channels=spec_channels,
                                       style_vector_dim=c.gin_channels)
        post = lambda: PosteriorAudioEncoder(  # noqa: E731
            spec_channels, c.inter_channels, c.hidden_channels, 5, 1,
            c.posterior_wn_layers, gin_channels=c.gin_channels,
            down_rates=c.posterior_down_rates, down_kernels=c.posterior_down_kernels,
            down_channels=c.posterior_down_channels, rb_kernels=c.posterior_rb_kernels,
            rb_dils=c.posterior_rb_dilations)
        self.enc_p = post()
        if for_training:
            self.enc_q = post()
        self.enc_p_2 = TextEncoder(
            c.inter_channels, c.hidden_channels, c.filter_channels, c.n_heads, c.n_layers,
            c.kernel_size, n_text_tokens=c.n_text_tokens, mrte_hidden=c.gin_channels,
            p_dropout=c.p_dropout)
        self.flow = ResidualCouplingBlock(
            c.inter_channels, c.hidden_channels, 5, 1, c.flow_wn_layers,
            n_flows=c.flow_layers, gin_channels=c.gin_channels)
        self.dec = Generator(
            c.inter_channels, c.resblock_kernel_sizes, c.resblock_dilation_sizes,
            c.upsample_rates, c.upsample_initial_channel, c.upsample_kernel_sizes,
            gin_channels=c.gin_channels)
        self.quantizer = ResidualVQ(c.inter_channels, c.n_q, c.codebook_bins,
                                    decay=c.codebook_decay, kmeans_seeding=c.kmeans_seeding,
                                    kmeans_pending=for_training)
        self.proj = Conv1d(c.inter_channels, c.inter_channels, 2, stride=2, padding=(0, 0))

    @staticmethod
    def _even(spec, what: str) -> None:
        if spec.shape[1] % 2:
            raise ValueError(f"{what}: {spec.shape[1]} spectrogram frames; the stride-2 "
                             "content path needs an even count")

    def forward(self, wav, wav_aug, spec, spec_aug, spec_lengths, text, text_lengths,
                noise: Optional[torch.Tensor] = None, ids_slice: Optional[torch.Tensor] = None,
                vq_draws=None, generator: Optional[torch.Generator] = None, mesh=None):
        """The training forward, JAX's `__call__` (vq2.py:840-871), in train
        mode when the module is (dropout, the codebook's EMA / k-means
        update, enc_q's noise, random slices). wav, wav_aug (B, T*hop, 1),
        spec, spec_aug (B, T, spec_channels), T even → (y_hat (B,
        segment_frames*hop, 1), commit loss, ids_slice (B,), y_mask (B, T,
        1), (z, z_p, m_p, logs_p, m_q, logs_q), quantized (B, T, D)).
        `noise` (enc_q's, the shape of m_q), `ids_slice` and `vq_draws`
        (quantize.vq_draws) replace the draws from `generator`. `mesh`: the
        batch is this rank's rows of a data-parallel batch, and the
        codebook's update is the global batch's (quantize.rvq_forward)."""
        if not hasattr(self, "enc_q"):
            raise RuntimeError("the training forward needs SynthesizerTrn(for_training=True)")
        self._even(spec, "forward")
        train = self.training
        y_mask = sequence_mask(spec_lengths, spec.shape[1])
        ge = self.ref_enc(spec * y_mask, y_mask)
        x = self.proj(self.enc_p(spec_aug, wav_aug, y_mask, g=ge)[0])
        if train:
            quantized, _, commit_loss = self.quantizer.forward_train(x, vq_draws, generator,
                                                                     mesh)
        else:
            quantized, _ = self.quantizer(x)
            commit_loss = torch.zeros((), device=x.device)
        quantized = quantized.repeat_interleave(2, dim=1)
        text_mask = sequence_mask(text_lengths, text.shape[1])
        _, m_p, logs_p = self.enc_p_2(quantized, y_mask, text, text_mask, ge)
        if train and noise is None:
            dev = spec.device if generator is None else generator.device
            noise = torch.randn(m_p.shape, generator=generator, device=dev).to(spec.device)
        z, m_q, logs_q = self.enc_q(spec, wav, y_mask, g=ge, noise=noise if train else None)
        z_p = self.flow(z, y_mask, g=ge)
        if train:
            z_slice, ids_slice = rand_slice_segments(z, spec_lengths, self.segment_frames,
                                                     ids_slice, generator)
        else:
            z_slice = z[:, :self.segment_frames]
            ids_slice = torch.zeros(z.shape[0], dtype=torch.long, device=z.device)
        o = self.dec(z_slice, g=ge)
        return o, commit_loss, ids_slice, y_mask, (z, z_p, m_p, logs_p, m_q, logs_q), quantized

    def extract_code(self, wav, spec, spec_lengths):
        """wav + spec → semantic VQ codes (B, n_q, T/2) (vq2.py:912-919)."""
        y_mask = sequence_mask(spec_lengths, spec.shape[1])
        ge = self.ref_enc(spec * y_mask, y_mask)
        x = self.enc_p(spec, wav, y_mask, g=ge)[0]
        x = self.proj(x * y_mask)
        return self.quantizer.encode(x).transpose(0, 1)

    def _content_codes(self, spec, wav, y_mask, ge):
        """enc_p → stride-2 proj → the quantizer's eval forward (the VQ
        kernel) → 2x nearest upsample: (quantized (B, 2*floor(T/2), D),
        codes (n_q, B, T/2))."""
        quantized, codes = self.quantizer(self.proj(self.enc_p(spec, wav, y_mask, g=ge)[0]))
        return quantized.repeat_interleave(2, dim=1), codes

    def _synthesize(self, quantized, y_mask, text, text_mask, ge, noise_scale, noise,
                    generator):
        """The prior enc_p_2, z_p = m_p + noise * exp(logs_p) * noise_scale,
        the flow's reverse pass and dec. `noise` (the shape of m_p) is drawn
        from `generator` when None."""
        _, m_p, logs_p = self.enc_p_2(quantized, y_mask, text, text_mask, ge)
        if noise is None:
            noise = torch.randn(m_p.shape, generator=generator, device=m_p.device)
        z_p = m_p + noise * torch.exp(logs_p) * noise_scale
        z = self.flow(z_p, y_mask, g=ge, reverse=True)
        return self.dec(z * y_mask, g=ge)

    def infer(self, wav, spec, spec_lengths, text, text_lengths, noise_scale: float = 0.5,
              noise: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None):
        """Codec reconstruction (vq2.py:873-890): wav (B, T*hop, 1), spec
        (B, T, spec_channels) → wav (B, T*hop, 1). T must be even: the
        stride-2 content path gives 2*floor(T/2) frames, which the JAX
        package's masks do not broadcast against either."""
        self._even(spec, "infer")
        y_mask = sequence_mask(spec_lengths, spec.shape[1])
        ge = self.ref_enc(spec * y_mask, y_mask)
        quantized, _ = self._content_codes(spec, wav, y_mask, ge)
        text_mask = sequence_mask(text_lengths, text.shape[1])
        return self._synthesize(quantized, y_mask, text, text_mask, ge, noise_scale, noise,
                                generator)

    def decode(self, codes, text, refer_spec, noise_scale: float = 0.5,
               noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
        """codes (n_q, B, T/2) + text (B, L) + reference spec (B, Tr,
        spec_channels) → wav (B, T*hop, 1), unmasked (the JAX package's
        decode, the intended semantics of vq2.py:892-911)."""
        ge = self.ref_enc(refer_spec, torch.ones_like(refer_spec[..., :1]))
        quantized = self.quantizer.decode(codes).repeat_interleave(2, dim=1)
        y_mask = torch.ones_like(quantized[..., :1])
        text_mask = torch.ones(text.shape + (1,), device=quantized.device)
        return self._synthesize(quantized, y_mask, text, text_mask, ge, noise_scale, noise,
                                generator)
