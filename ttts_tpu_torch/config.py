"""Typed configuration tree, the port's own copy of ttts_tpu/config.py.

The same dataclasses with the same names, fields and defaults (the tests
compare `dataclasses.asdict` of both `default_config()`s), so a config of the
JAX package translates field for field. Field names mirror the reference
configs (ttts/gpt/config.json, ttts/vqvae/config.json,
ttts/diffusion/config.yaml, ttts/clvp/config.json,
ttts/classifier/config.json). The port reads the serving fields; the
training, classifier and mesh fields are carried so that the trees stay equal.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class AudioConfig:
    """Codec-side audio format (reference ttts/vqvae/config.json `data` block)."""

    max_wav_value: float = 32768.0
    sampling_rate: int = 32000
    filter_length: int = 2048
    hop_length: int = 640
    win_length: int = 2048
    n_mel_channels: int = 128
    mel_fmin: float = 0.0
    mel_fmax: Optional[float] = None


@dataclass(frozen=True)
class AcousticMelConfig:
    """24 kHz acoustic mel for GPT conditioning / diffusion / vocoder."""

    sample_rate: int = 24000
    n_fft: int = 1024
    hop_length: int = 256
    n_mels: int = 100
    padding: str = "center"  # "center" | "same"


@dataclass(frozen=True)
class VQVAEConfig:
    """SynthesizerTrn hyperparams (reference ttts/vqvae/config.json `vqvae`)."""

    inter_channels: int = 192
    hidden_channels: int = 192
    filter_channels: int = 768
    n_heads: int = 2
    n_layers: int = 6
    kernel_size: int = 3
    p_dropout: float = 0.1
    resblock: str = "1"
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    upsample_rates: Tuple[int, ...] = (10, 8, 2, 2, 2)
    upsample_initial_channel: int = 512
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 8, 2, 2)
    n_layers_q: int = 3
    posterior_wn_layers: int = 16
    # posterior raw-audio downsample stack; prod(rates) equals the codec hop
    posterior_down_rates: Tuple[int, ...] = (10, 8, 2, 2, 2)
    posterior_down_kernels: Tuple[int, ...] = (16, 16, 8, 2, 2)
    posterior_down_channels: Tuple[int, ...] = (16, 32, 64, 96, 128, 192)
    posterior_rb_kernels: Tuple[int, ...] = (3, 7, 11)
    posterior_rb_dilations: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5), (1, 3, 5), (1, 3, 5))
    flow_layers: int = 4
    flow_wn_layers: int = 4
    use_spectral_norm: bool = False
    gin_channels: int = 512
    semantic_frame_rate: str = "25hz"
    freeze_quantizer: bool = False
    n_q: int = 1
    codebook_bins: int = 1024
    codebook_decay: float = 0.99
    kmeans_seeding: str = "farthest_point"
    n_text_tokens: int = 256


@dataclass(frozen=True)
class GPTConfig:
    """UnifiedVoice hyperparams (reference ttts/gpt/config.json `gpt`)."""

    model_dim: int = 512
    max_mel_tokens: int = 1600
    max_text_tokens: int = 800
    heads: int = 8
    use_mel_codes_as_input: bool = True
    layers: int = 6
    number_text_tokens: int = 256
    number_mel_codes: int = 1026
    start_mel_token: int = 1024
    stop_mel_token: int = 1025
    start_text_token: int = 255
    stop_text_token: int = 0
    train_solo_embeddings: bool = False
    checkpointing: bool = False
    max_conditioning_inputs: int = 1
    dropout: float = 0.1
    attn_dropout: Optional[float] = None
    flash_attention: bool = False
    fused_decode: bool = True
    decode_spmd: bool = False


@dataclass(frozen=True)
class DiffusionNetConfig:
    """AA_diffusion hyperparams (reference ttts/diffusion/config.yaml `aa_diffusion`)."""

    in_channels: int = 100
    out_channels: int = 200
    model_channels: int = 512
    num_heads: int = 16
    num_layers: int = 6
    in_latent_channels: int = 512
    dropout: float = 0.0
    layer_drop: float = 0.1


@dataclass(frozen=True)
class DiffusionProcessConfig:
    """Gaussian diffusion schedule (reference diffusion/train.py:85-99)."""

    trained_timesteps: int = 1000
    noise_schedule: str = "linear"
    model_mean_type: str = "epsilon"
    model_var_type: str = "learned_range"
    infer_timesteps: int = 50
    sampler: str = "dpm++2m"
    cond_free: bool = True
    cond_free_k: float = 2.0


@dataclass(frozen=True)
class CLVPConfig:
    """CLVP hyperparams (reference ttts/clvp/config.json `clvp` + model.py:28-62)."""

    dim_text: int = 768
    dim_speech: int = 768
    dim_latent: int = 768
    num_text_tokens: int = 256
    num_speech_tokens: int = 8192
    text_enc_depth: int = 20
    speech_enc_depth: int = 20
    text_heads: int = 16
    speech_heads: int = 16
    text_seq_len: int = 350
    speech_seq_len: int = 430
    text_mask_percentage: float = 0.0
    voice_mask_percentage: float = 0.0
    # encoder flavour: True → x-transformers (RMSNorm / GLU / rotary), the
    # serving default; False → the plain Transformer (the v2 trainer's)
    use_xformers: bool = True
    dim_head: int = 64


@dataclass(frozen=True)
class ClassifierConfig:
    """Audio quality classifier (reference ttts/classifier/config.json)."""

    classes: int = 2
    spec_dim: int = 100
    embedding_dim: int = 512
    depth: int = 5
    downsample_factor: int = 4
    resnet_blocks: int = 2
    attn_blocks: int = 4
    num_attn_heads: int = 4
    base_channels: int = 32
    dropout: float = 0.0
    kernel_size: int = 5
    distribute_zero_label: bool = False
    pad_to_mel_frames: int = 700


@dataclass(frozen=True)
class VocosConfig:
    """Vocos backbone/head (reference ttts/vocoder/config.yaml + models.py:26)."""

    input_channels: int = 100
    dim: int = 512
    intermediate_dim: int = 1536
    num_layers: int = 8
    n_fft: int = 1024
    hop_length: int = 256
    padding: str = "center"


@dataclass(frozen=True)
class TrainConfig:
    """Trainer knobs (union of the reference `train` blocks)."""

    train_steps: int = 300_000
    val_freq: int = 100
    save_freq: int = 1000
    keep_ckpts: int = 3
    lr: float = 1e-4
    warmup_steps: int = 500
    weight_decay: float = 0.01
    betas: Tuple[float, float] = (0.9, 0.96)
    eps: float = 1e-8
    grad_clip: float = 1.0
    accumulate_num: int = 1
    batch_size: int = 32
    logs_folder: str = "logs"
    seed: int = 1234
    amp: bool = True
    text_weight: float = 0.01
    mel_weight: float = 1.0
    c_mel: float = 45.0
    c_kl: float = 1.0
    segment_size: int = 20480
    lr_decay: float = 0.999875
    epochs: int = 100
    formant_shift: float = 1.4
    pitch_shift: float = 2.0
    pitch_range: float = 1.5
    cutoff_lowpass: float = 60.0
    cutoff_highpass: float = 10000.0
    q_min: float = 2.0
    q_max: float = 5.0
    num_peak: int = 8
    g_min: float = -12.0
    g_max: float = 12.0
    aug_warp: bool = True
    aug_warp_device: bool = True
    unconditioned_percentage: float = 0.1
    timesteps: int = 1000


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh spec."""

    data: int = -1
    model: int = 1
    dcn: int = 1
    axis_names: Tuple[str, ...] = ("data", "model")


@dataclass(frozen=True)
class TTTSConfig:
    """Root config."""

    audio: AudioConfig = field(default_factory=AudioConfig)
    acoustic_mel: AcousticMelConfig = field(default_factory=AcousticMelConfig)
    vqvae: VQVAEConfig = field(default_factory=VQVAEConfig)
    gpt: GPTConfig = field(default_factory=GPTConfig)
    diffusion_net: DiffusionNetConfig = field(default_factory=DiffusionNetConfig)
    diffusion: DiffusionProcessConfig = field(default_factory=DiffusionProcessConfig)
    clvp: CLVPConfig = field(default_factory=CLVPConfig)
    classifier: ClassifierConfig = field(default_factory=ClassifierConfig)
    vocos: VocosConfig = field(default_factory=VocosConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)


def default_config() -> TTTSConfig:
    return TTTSConfig()


@dataclass(frozen=True)
class MLAMoEConfig:
    """A public LLM block as the trunk of UnifiedVoice (models/mla_moe.py):
    multi-head latent attention and sigmoid-routed experts with shared
    experts, under the published `deepseek_v3` config.json's key names.
    The defaults are Moonlight-16B-A3B's
    (https://huggingface.co/moonshotai/Moonlight-16B-A3B/blob/main/config.json);
    the trunk keeps UnifiedVoice's own embeddings, position tables and heads,
    so `vocab_size` is not read. Kept apart from TTTSConfig, whose tree
    equals the JAX package's; `check_matches` ties it to a GPTConfig."""

    attention_bias: bool = False
    ep_size: int = 1
    first_k_dense_replace: int = 1
    hidden_act: str = "silu"
    hidden_size: int = 2048
    intermediate_size: int = 11264
    kv_lora_rank: int = 512
    max_position_embeddings: int = 8192
    model_type: str = "deepseek_v3"
    moe_intermediate_size: int = 1408
    moe_layer_freq: int = 1
    n_group: int = 1
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    norm_topk_prob: bool = True
    num_attention_heads: int = 16
    num_experts_per_tok: int = 6
    num_hidden_layers: int = 27
    num_key_value_heads: int = 16
    num_nextn_predict_layers: int = 0
    q_lora_rank: Optional[int] = None
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    rms_norm_eps: float = 1e-5
    rope_theta: float = 50000.0
    routed_scaling_factor: float = 2.446
    scoring_func: str = "sigmoid"
    seq_aux: bool = True
    tie_word_embeddings: bool = False
    topk_group: int = 1
    topk_method: str = "noaux_tc"
    v_head_dim: int = 128
    vocab_size: int = 163840

    @classmethod
    def from_published(cls, data: dict) -> "MLAMoEConfig":
        """The fields found among `data`'s keys (a config.json, or a file
        that holds its keys beside others); every field must be there."""
        names = [f.name for f in dataclasses.fields(cls)]
        missing = [n for n in names if n not in data]
        if missing:
            raise KeyError(f"MLAMoEConfig: keys missing: {missing}")
        return cls(**{n: data[n] for n in names})

    def check_matches(self, gpt: "GPTConfig") -> None:
        """Raise where the GPTConfig the trunk serves disagrees with it, or
        where the block takes a setting the port does not compute."""
        for mine, theirs, what in ((self.hidden_size, gpt.model_dim, "hidden_size / model_dim"),
                                   (self.num_attention_heads, gpt.heads,
                                    "num_attention_heads / heads"),
                                   (self.num_hidden_layers, gpt.layers,
                                    "num_hidden_layers / layers")):
            if mine != theirs:
                raise ValueError(f"MLAMoEConfig and GPTConfig disagree on {what}: {mine} != "
                                 f"{theirs}")
        unsupported = {"q_lora_rank": self.q_lora_rank is not None,
                       "n_group / topk_group": (self.n_group, self.topk_group) != (1, 1),
                       "scoring_func": self.scoring_func != "sigmoid",
                       "topk_method": self.topk_method != "noaux_tc",
                       "hidden_act": self.hidden_act != "silu",
                       "attention_bias": self.attention_bias,
                       "moe_layer_freq": self.moe_layer_freq != 1,
                       "num_key_value_heads": self.num_key_value_heads != self.num_attention_heads}
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise NotImplementedError(f"MLAMoEConfig: the port does not compute {bad}")


def to_dict(cfg) -> dict:
    """A config dataclass → nested plain dicts (ttts_tpu.config.to_dict)."""
    return dataclasses.asdict(cfg)


def _from_dict(cls, data: dict):
    """A config dataclass from a plain dict: strict keys, nested configs
    from nested dicts, lists as tuples (ttts_tpu.config._from_dict)."""
    names = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in data.items():
        if k not in names:
            raise KeyError(f"{cls.__name__}: unknown config key {k!r}")
        sub = globals().get(names[k].type)  # annotations are strings here
        if isinstance(sub, type) and dataclasses.is_dataclass(sub) and isinstance(v, dict):
            kwargs[k] = _from_dict(sub, v)
        else:
            kwargs[k] = _coerce(v)
    return cls(**kwargs)


def _coerce(v: Any) -> Any:
    if isinstance(v, list):
        return tuple(_coerce(x) for x in v)
    return v


def load_config(path: str | pathlib.Path) -> TTTSConfig:
    """A TTTSConfig from a .json or .yaml/.yml file (ttts_tpu.config.load_config)."""
    p = pathlib.Path(path)
    text = p.read_text()
    if p.suffix in (".yaml", ".yml"):
        import yaml

        return _from_dict(TTTSConfig, yaml.safe_load(text))
    return _from_dict(TTTSConfig, json.loads(text))
