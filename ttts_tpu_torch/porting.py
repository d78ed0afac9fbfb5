"""Weight carry-over from the JAX package: ttts_tpu params → this package's
state dicts (numpy arrays under the reference's torch key names).

Each function is the inverse of its counterpart in ttts_tpu/models/porting.py
(or models/vocos.py for Vocos), which map a reference torch state dict onto
flax params: feeding the state dict produced here back through that function
returns the JAX params. One exception: the codec's transposed convolutions
(dec.ups.*) keep the JAX module's weight norm, per output channel, where the
reference's (and so the JAX porter's input) is per input channel. Inputs are
the JAX package's variable trees (nested dicts of arrays; jax arrays convert
through np.asarray, so no JAX import is needed here).

Layouts: flax Conv kernels (k, in, out) → torch (out, in, k); flax Dense
(in, out) → torch Linear (out, in); GPT-2 Conv1D weights stay (in, out);
flax WeightNorm (kernel v, scale g) → (weight_v, weight_g).

The maps only relayout, so they carry gradients as they carry weights.
`unified_voice_variables`, `aa_diffusion_variables`,
`synthesizer_trn_variables`, `discriminator_variables`, `clvp_variables`
and `classifier_variables` go the other way,
from this package's state dicts (numpy arrays or tensors) to the JAX
variable trees (VARIABLES_FNS; train/checkpoints.export_release writes
them in the JAX package's release format), and so do the model library's:
RVQ1, the DVAE, the group quantizer, MelStyleEncoderVAE,
TransformerDecoder, one flow of models/flows.py (told by its parameters),
the depthwise-separable convolutions, FFT and TransformerCouplingLayer.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

StateDict = Dict[str, np.ndarray]


def _a(x) -> np.ndarray:
    return np.array(x, dtype=np.float32)  # a writable copy


def _bias(sd: StateDict, p: str, tree) -> None:
    if "bias" in tree:
        sd[p + ".bias"] = _a(tree["bias"])


def _conv(sd: StateDict, p: str, tree) -> None:
    """blocks.Conv1d subtree {Conv_0, [WeightNorm_0]} → torch conv at p."""
    inner = tree["Conv_0"]
    v = _a(inner["kernel"]).transpose(2, 1, 0)
    if "WeightNorm_0" in tree:
        g = _a(tree["WeightNorm_0"]["Conv_0/kernel/scale"])
        sd[p + ".weight_v"] = v
        sd[p + ".weight_g"] = g.reshape(-1, 1, 1)
    else:
        sd[p + ".weight"] = v
    _bias(sd, p, inner)


def _conv_flax(sd: StateDict, p: str, tree) -> None:
    """bare flax nn.Conv {kernel, bias} → torch Conv1d."""
    sd[p + ".weight"] = _a(tree["kernel"]).transpose(2, 1, 0)
    _bias(sd, p, tree)


def _dense(sd: StateDict, p: str, tree) -> None:
    """flax Dense → torch nn.Linear."""
    sd[p + ".weight"] = _a(tree["kernel"]).T
    _bias(sd, p, tree)


def _dense_as_conv1x1(sd: StateDict, p: str, tree) -> None:
    """flax Dense → torch 1x1 Conv1d (out, in, 1)."""
    sd[p + ".weight"] = _a(tree["kernel"]).T[:, :, None]
    _bias(sd, p, tree)


def _conv1x1_as_linear(sd: StateDict, p: str, tree) -> None:
    """1x1 blocks.Conv1d (kernel (1, in, out)) → torch nn.Linear."""
    sd[p + ".weight"] = _a(tree["Conv_0"]["kernel"])[0].T
    _bias(sd, p, tree["Conv_0"])


def _norm(sd: StateDict, p: str, tree) -> None:
    """flax LayerNorm / GroupNorm {scale, bias} → torch {weight, bias}."""
    sd[p + ".weight"] = _a(tree["scale"])
    sd[p + ".bias"] = _a(tree["bias"])


def _count(tree, prefix: str) -> int:
    return sum(1 for k in tree if k.startswith(prefix))


# --------------------------------------------------------------------- codec


def _wn(sd: StateDict, p: str, tree) -> None:
    """blocks.WN: Conv1d_0 = cond_layer, then in_layers / res_skip_layers."""
    n = _count(tree, "Conv1d_")
    base = n % 2  # cond_layer present → odd count
    if base:
        _conv(sd, p + ".cond_layer", tree["Conv1d_0"])
    for i in range((n - base) // 2):
        _conv(sd, f"{p}.in_layers.{i}", tree[f"Conv1d_{base + 2 * i}"])
        _conv(sd, f"{p}.res_skip_layers.{i}", tree[f"Conv1d_{base + 2 * i + 1}"])


def _resblock1(sd: StateDict, p: str, tree) -> None:
    for j in range(_count(tree, "Conv1d_") // 2):
        _conv(sd, f"{p}.convs1.{j}", tree[f"Conv1d_{2 * j}"])
        _conv(sd, f"{p}.convs2.{j}", tree[f"Conv1d_{2 * j + 1}"])


def _mel_style_encoder(sd: StateDict, p: str, tree) -> None:
    _dense(sd, p + ".spectral.0.fc", tree["Dense_0"])
    _dense(sd, p + ".spectral.3.fc", tree["Dense_1"])
    _conv(sd, p + ".temporal.0.conv1.conv", tree["Conv1dGLU_0"]["Conv1d_0"])
    _conv(sd, p + ".temporal.1.conv1.conv", tree["Conv1dGLU_1"]["Conv1d_0"])
    att = tree["RelPosMultiHeadAttention_0"]
    for i, name in enumerate(("w_qs", "w_ks", "w_vs", "fc")):
        _conv1x1_as_linear(sd, f"{p}.slf_attn.{name}", att[f"Conv1d_{i}"])
    _dense(sd, p + ".fc.fc", tree["Dense_2"])


def _posterior_audio_encoder(sd: StateDict, p: str, tree) -> None:
    n_down = _count(tree, "Conv1d_") - 4  # + down_pre, conv_post, pre, proj
    n_rb = _count(tree, "ResBlock1_") // n_down
    _conv(sd, p + ".down_pre", tree["Conv1d_0"])
    for i in range(n_down):
        _conv(sd, f"{p}.downs.{i}", tree[f"Conv1d_{i + 1}"])
        for j in range(n_rb):
            k = i * n_rb + j
            _resblock1(sd, f"{p}.resblocks.{k}", tree[f"ResBlock1_{k}"])
    snake = tree["AntiAliasedActivation_0"]["SnakeBeta_0"]
    sd[p + ".activation_post.act.alpha"] = _a(snake["log_alpha"])
    sd[p + ".activation_post.act.beta"] = _a(snake["log_beta"])
    _conv(sd, p + ".conv_post", tree[f"Conv1d_{n_down + 1}"])
    _conv(sd, p + ".pre", tree[f"Conv1d_{n_down + 2}"])
    _wn(sd, p + ".enc", tree["WN_0"])
    _conv(sd, p + ".proj", tree[f"Conv1d_{n_down + 3}"])


def _layernorm(sd: StateDict, p: str, tree) -> None:
    """flax LayerNorm {scale, bias} → the reference's modules.LayerNorm
    {gamma, beta}."""
    sd[p + ".gamma"] = _a(tree["scale"])
    sd[p + ".beta"] = _a(tree["bias"])


def _vits_mha(sd: StateDict, p: str, tree) -> None:
    for i, name in enumerate(("conv_q", "conv_k", "conv_v", "conv_o")):
        _conv(sd, f"{p}.{name}", tree[f"Conv1d_{i}"])
    for name in ("emb_rel_k", "emb_rel_v"):
        if name in tree:
            sd[f"{p}.{name}"] = _a(tree[name])


def _vits_encoder(sd: StateDict, p: str, tree) -> None:
    for i in range(_count(tree, "RelPosMultiHeadAttention_")):
        _vits_mha(sd, f"{p}.attn_layers.{i}", tree[f"RelPosMultiHeadAttention_{i}"])
        _layernorm(sd, f"{p}.norm_layers_1.{i}", tree[f"LayerNorm_{2 * i}"])
        ffn = tree[f"ConvFFN_{i}"]
        _conv(sd, f"{p}.ffn_layers.{i}.conv_1", ffn["Conv1d_0"])
        _conv(sd, f"{p}.ffn_layers.{i}.conv_2", ffn["Conv1d_1"])
        _layernorm(sd, f"{p}.norm_layers_2.{i}", tree[f"LayerNorm_{2 * i + 1}"])


def _text_encoder(sd: StateDict, p: str, tree) -> None:
    _vits_encoder(sd, p + ".encoder_ssl", tree["TransformerEncoder_0"])
    sd[p + ".text_embedding.weight"] = _a(tree["Embed_0"]["embedding"])
    _vits_encoder(sd, p + ".encoder_text", tree["TransformerEncoder_1"])
    mrte = tree["MRTE_0"]
    _conv(sd, p + ".mrte.c_pre", mrte["Conv1d_0"])
    _conv(sd, p + ".mrte.text_pre", mrte["Conv1d_1"])
    _vits_mha(sd, p + ".mrte.cross_attention", mrte["RelPosMultiHeadAttention_0"])
    _conv(sd, p + ".mrte.c_post", mrte["Conv1d_2"])
    _vits_encoder(sd, p + ".encoder2", tree["TransformerEncoder_2"])
    _conv(sd, p + ".proj", tree["Conv1d_0"])


def _coupling_flow(sd: StateDict, p: str, tree) -> None:
    """flows.{2i} are the coupling layers; flows.{2i+1} the parameter-free flips."""
    for i in range(_count(tree, "ResidualCouplingLayer_")):
        lyr, fp = tree[f"ResidualCouplingLayer_{i}"], f"{p}.flows.{2 * i}"
        _conv(sd, fp + ".pre", lyr["Conv1d_0"])
        _wn(sd, fp + ".enc", lyr["WN_0"])
        _dense_as_conv1x1(sd, fp + ".post", lyr["Dense_0"])


def _conv_transpose(sd: StateDict, p: str, tree) -> None:
    """blocks.ConvTranspose1d {kernel (k, in, out), [g (out,)], bias} → the
    port's ConvTranspose1d, the same parameterisation relaid: weight (in,
    out, k), or weight_v (in, out, k) and weight_g (1, out, 1) with weight
    norm."""
    w = _a(tree["kernel"]).transpose(1, 2, 0)
    if "g" in tree:
        sd[p + ".weight_v"] = w
        sd[p + ".weight_g"] = _a(tree["g"]).reshape(1, -1, 1)
    else:
        sd[p + ".weight"] = w
    _bias(sd, p, tree)


def _generator(sd: StateDict, p: str, tree) -> None:
    _conv(sd, p + ".conv_pre", tree["Conv1d_0"])
    _conv(sd, p + ".cond", tree["Conv1d_1"])
    _conv(sd, p + ".conv_post", tree["Conv1d_2"])
    n_up = _count(tree, "ConvTranspose1d_")
    n_rb = _count(tree, "ResBlock1_") // n_up
    for i in range(n_up):
        _conv_transpose(sd, f"{p}.ups.{i}", tree[f"ConvTranspose1d_{i}"])
        for j in range(n_rb):
            k = i * n_rb + j
            _resblock1(sd, f"{p}.resblocks.{k}", tree[f"ResBlock1_{k}"])


def synthesizer_trn_state_dict(variables, for_training: bool = False) -> StateDict:
    """JAX SynthesizerTrn variables {'params', 'codebook'} → the state dict
    of ttts_tpu_torch.models.vqvae.SynthesizerTrn (ref_enc, enc_p, enc_p_2,
    flow, dec, proj, the quantizer's full codebook state). enc_q, which
    serving does not build and release exports drop, is skipped but for
    the model built with `for_training`."""
    params = variables["params"]
    sd: StateDict = {}
    _mel_style_encoder(sd, "ref_enc", params["ref_enc"])
    _posterior_audio_encoder(sd, "enc_p", params["enc_p"])
    if for_training:
        _posterior_audio_encoder(sd, "enc_q", params["enc_q"])
    _text_encoder(sd, "enc_p_2", params["enc_p_2"])
    _coupling_flow(sd, "flow", params["flow"])
    _generator(sd, "dec", params["dec"])
    _conv(sd, "proj", params["proj"])
    _codebook(sd, "quantizer", variables["codebook"]["quantizer"]["state"])
    return sd


def _codebook(sd: StateDict, p: str, state) -> None:
    """A quantizer's RVQState (or its dict) → the EnCodec codebook buffers
    of each layer, p.vq.layers.{i}._codebook.*."""
    get = (lambda k: state[k]) if isinstance(state, dict) else (lambda k: getattr(state, k))
    embed, embed_avg, size = _a(get("embed")), _a(get("embed_avg")), _a(get("cluster_size"))
    inited = np.asarray(get("inited"), np.float32).reshape(1)
    for i in range(embed.shape[0]):
        cb = f"{p}.vq.layers.{i}._codebook"
        sd[cb + ".embed"] = embed[i]
        sd[cb + ".embed_avg"] = embed_avg[i]
        sd[cb + ".cluster_size"] = size[i]
        sd[cb + ".inited"] = inited


# ----------------------------------------------------------------------- gpt


def unified_voice_state_dict(variables) -> StateDict:
    """JAX UnifiedVoice variables → ttts_tpu_torch.models.gpt.UnifiedVoice
    state dict. Inverse of port_unified_voice_state."""
    p = variables["params"]
    sd: StateDict = {
        "text_embedding.weight": _a(p["text_embedding"]["embedding"]),
        "mel_embedding.weight": _a(p["mel_embedding"]["embedding"]),
        "text_pos_embedding.emb.weight": _a(p["text_pos_embedding"]),
        "mel_pos_embedding.emb.weight": _a(p["mel_pos_embedding"]),
    }
    _norm(sd, "final_norm", p["final_norm"])
    _dense(sd, "text_head", p["text_head"])
    _dense(sd, "mel_head", p["mel_head"])
    stack = p["gpt"]
    for i in range(_count(stack, "GPT2Block_")):
        blk, pre = stack[f"GPT2Block_{i}"], f"gpt.h.{i}"
        _norm(sd, pre + ".ln_1", blk["LayerNorm_0"])
        _norm(sd, pre + ".ln_2", blk["LayerNorm_1"])
        for name, dense in (("attn.c_attn", "Dense_0"), ("attn.c_proj", "Dense_1"),
                            ("mlp.c_fc", "Dense_2"), ("mlp.c_proj", "Dense_3")):
            sd[f"{pre}.{name}.weight"] = _a(blk[dense]["kernel"])  # Conv1D: (in, out)
            sd[f"{pre}.{name}.bias"] = _a(blk[dense]["bias"])
    _norm(sd, "gpt.ln_f", stack["ln_f"])
    return sd


# ----------------------------------------------------------------- diffusion


def _attn_block(sd: StateDict, p: str, tree) -> None:
    _norm(sd, p + ".norm", tree["norm"]["GroupNorm_0"])
    _dense_as_conv1x1(sd, p + ".qkv", tree["qkv"])
    _dense_as_conv1x1(sd, p + ".proj_out", tree["proj"])
    if "relpos" in tree:
        sd[p + ".relative_pos_embeddings.relative_attention_bias.weight"] = _a(
            tree["relpos"]["table"]["embedding"])


def _ss_resblock(sd: StateDict, p: str, tree) -> None:
    _norm(sd, p + ".in_layers.0", tree["GroupNorm32_0"]["GroupNorm_0"])
    _dense_as_conv1x1(sd, p + ".in_layers.2", tree["Dense_0"])
    _dense(sd, p + ".emb_layers.1", tree["Dense_1"])
    _norm(sd, p + ".out_layers.0", tree["GroupNorm32_1"]["GroupNorm_0"])
    _conv_flax(sd, p + ".out_layers.3", tree["Conv_0"])


def _diffusion_layer(sd: StateDict, p: str, tree) -> None:
    _ss_resblock(sd, p + ".resblk", tree["resblk"])
    _attn_block(sd, p + ".attn", tree["attn"])


def _ref_encoder(sd: StateDict, p: str, tree) -> None:
    sd[p + ".latents"] = _a(tree["latents"])
    for i, name in enumerate(("conv_q", "conv_k", "conv_v", "conv_o")):
        _dense_as_conv1x1(sd, f"{p}.cross_attention.{name}", tree[f"Dense_{i}"])
    _conv_flax(sd, p + ".enc.0", tree["Conv_0"])
    for i in range(_count(tree, "AttentionBlock_")):
        _attn_block(sd, f"{p}.enc.{i + 1}", tree[f"AttentionBlock_{i}"])


def _diffusion_trunk(sd: StateDict, p) -> None:
    """The parts of diffusion_net.DiffusionTrunk (AA_diffusion's and
    DiffusionTts's flax trees name them alike)."""
    _conv_flax(sd, "inp_block", p["inp_block"])
    _dense(sd, "time_embed.0", p["time_embed_0"])
    _dense(sd, "time_embed.2", p["time_embed_1"])
    sd["unconditioned_embedding"] = _a(p["unconditioned_embedding"]).transpose(0, 2, 1)
    _dense_as_conv1x1(sd, "integrating_conv", p["integrating_conv"])
    _norm(sd, "out.0", p["out_norm"]["GroupNorm_0"])
    _conv_flax(sd, "out.2", p["out_conv"])
    for i in range(3):
        _diffusion_layer(sd, f"conditioning_timestep_integrator.{i}",
                         p[f"conditioning_timestep_integrator_{i}"])
    for i in range(_count(p, "layers_")):
        tree = p[f"layers_{i}"]
        if "resblk" in tree:
            _diffusion_layer(sd, f"layers.{i}", tree)
        else:
            _ss_resblock(sd, f"layers.{i}", tree)


def aa_diffusion_state_dict(variables) -> StateDict:
    """JAX AA_diffusion variables → ttts_tpu_torch.models.diffusion_net.
    AA_diffusion state dict. Inverse of port_aa_diffusion_state."""
    p = variables["params"]
    sd: StateDict = {}
    _diffusion_trunk(sd, p)
    _norm(sd, "code_norm", p["code_norm"]["GroupNorm_0"])
    _conv_flax(sd, "latent_conditioner.0", p["latent_conditioner_0"])
    _conv_flax(sd, "refer_enc.0", p["refer_conv"])
    _ref_encoder(sd, "refer_enc.4", p["refer_pool"])
    for i in range(3):
        _attn_block(sd, f"latent_conditioner.{i + 1}", p[f"latent_conditioner_{i + 1}"])
        _attn_block(sd, f"refer_enc.{i + 1}", p[f"refer_attn_{i}"])
    return sd


def diffusion_tts_state_dict(variables) -> StateDict:
    """JAX DiffusionTts variables → ttts_tpu_torch.models.diffusion_tts_v1.
    DiffusionTts state dict, under the reference module's attribute names
    (ttts/diffusion/model.py: latent_conditioner = conv + 4 attention
    blocks, contextual_embedder = 2 strided convs + 5 attention blocks); no
    released checkpoint was checked against them."""
    p = variables["params"]
    sd: StateDict = {"code_embedding.weight": _a(p["code_embedding"]["embedding"])}
    _diffusion_trunk(sd, p)
    _norm(sd, "code_norm", p["code_norm"]["GroupNorm_0"])
    _conv_flax(sd, "latent_conditioner.0", p["latent_conditioner_conv"])
    _conv_flax(sd, "mel_head", p["mel_head"])
    for i in range(2):
        _conv_flax(sd, f"contextual_embedder.{i}", p[f"contextual_convs_{i}"])
    for prefix, name, first in (("code_converter", "code_converter", 0),
                                ("latent_conditioner", "latent_conditioner_attn", 1),
                                ("contextual_embedder", "contextual_attn", 2)):
        for i in range(_count(p, name + "_")):
            _attn_block(sd, f"{prefix}.{first + i}", p[f"{name}_{i}"])
    return sd


# ---------------------------------------------------------------------- clvp


def _clvp_encoder(sd: StateDict, p: str, tree) -> None:
    """clvp.CLVPEncoder → the reference's CheckpointedXTransformerEncoder
    keys: layers 2i (attention) and 2i+1 (GLU feed-forward), each
    [norms, wrapped block], then the wrapper's final LayerNorm."""
    for i in range(_count(tree, "EncoderLayer_")):
        lyr = tree[f"EncoderLayer_{i}"]
        ap = f"{p}.transformer.attn_layers.layers.{2 * i}"
        fp = f"{p}.transformer.attn_layers.layers.{2 * i + 1}"
        sd[ap + ".0.0.g"] = _a(lyr["RMSNorm_0"]["scale"])
        for j, name in enumerate(("to_q", "to_k", "to_v")):
            sd[f"{ap}.1.wrap.{name}.weight"] = _a(lyr[f"Dense_{j}"]["kernel"]).T
        _dense(sd, ap + ".1.wrap.to_out", lyr["Dense_3"])
        sd[fp + ".0.0.g"] = _a(lyr["RMSNorm_1"]["scale"])
        _dense(sd, fp + ".1.wrap.net.0.proj", lyr["Dense_4"])
        _dense(sd, fp + ".1.wrap.net.3", lyr["Dense_5"])
    _norm(sd, p + ".transformer.norm", tree["LayerNorm_0"])


def _clvp_plain_encoder(sd: StateDict, p: str, tree) -> None:
    """clvp.PlainEncoder → the reference's utils/transformer.py Transformer
    keys: layers.layers.{i}.0 = LayerScale(PreNorm(attention)), .1 =
    LayerScale(PreNorm(GEGLU feed-forward))."""
    for i in range(_count(tree, "PlainEncoderLayer_")):
        lyr, lp = tree[f"PlainEncoderLayer_{i}"], f"{p}.layers.layers.{i}"
        _norm(sd, lp + ".0.fn.norm", lyr["LayerNorm_0"])
        sd[lp + ".0.fn.fn.to_qkv.weight"] = _a(lyr["Dense_0"]["kernel"]).T
        _dense(sd, lp + ".0.fn.fn.to_out.0", lyr["Dense_1"])
        sd[lp + ".0.scale"] = _a(lyr["attn_gamma"])
        _norm(sd, lp + ".1.fn.norm", lyr["LayerNorm_1"])
        _dense(sd, lp + ".1.fn.fn.net.0", lyr["Dense_2"])
        _dense(sd, lp + ".1.fn.fn.net.3", lyr["Dense_3"])
        sd[lp + ".1.scale"] = _a(lyr["ff_gamma"])


def clvp_state_dict(variables) -> StateDict:
    """JAX CLVP variables, either flavour → ttts_tpu_torch.models.clvp.CLVP
    state dict. Inverse of port_clvp_xformers_state (use_xformers=True) and
    port_clvp_state (use_xformers=False, with the position tables)."""
    p = variables["params"]
    sd: StateDict = {
        "text_emb.weight": _a(p["Embed_0"]["embedding"]),
        "speech_emb.weight": _a(p["Embed_1"]["embedding"]),
        "to_text_latent.weight": _a(p["Dense_0"]["kernel"]).T,
        "to_speech_latent.weight": _a(p["Dense_1"]["kernel"]).T,
        "temperature": _a(p["temperature"]).reshape(()),
    }
    if "PlainEncoder_0" in p:
        sd["text_pos_emb.weight"] = _a(p["text_pos_emb"])
        sd["speech_pos_emb.weight"] = _a(p["speech_pos_emb"])
        _clvp_plain_encoder(sd, "text_transformer", p["PlainEncoder_0"])
        _clvp_plain_encoder(sd, "speech_transformer", p["PlainEncoder_1"])
    else:
        _clvp_encoder(sd, "text_transformer", p["CLVPEncoder_0"])
        _clvp_encoder(sd, "speech_transformer", p["CLVPEncoder_1"])
    return sd


# --------------------------------------------------------------------- vocos


def vocos_state_dict(variables) -> StateDict:
    """JAX Vocos variables → ttts_tpu_torch.models.vocos.Vocos state dict.
    Inverse of ttts_tpu.models.vocos.port_torch_state_dict."""
    p = variables["params"]
    bb = p["VocosBackbone_0"]
    sd: StateDict = {}
    _conv_flax(sd, "backbone.embed", bb["Conv_0"])
    _norm(sd, "backbone.norm", bb["LayerNorm_0"])
    for i in range(_count(bb, "ConvNeXtBlock_")):
        blk, pre = bb[f"ConvNeXtBlock_{i}"], f"backbone.convnext.{i}"
        _conv_flax(sd, pre + ".dwconv", blk["Conv_0"])
        _norm(sd, pre + ".norm", blk["LayerNorm_0"])
        _dense(sd, pre + ".pwconv1", blk["Dense_0"])
        _dense(sd, pre + ".pwconv2", blk["Dense_1"])
        sd[pre + ".gamma"] = _a(blk["gamma"])
    _norm(sd, "backbone.final_layer_norm", bb["LayerNorm_1"])
    _dense(sd, "head.out", p["ISTFTHead_0"]["Dense_0"])
    return sd


def _wn_conv(sd: StateDict, p: str, tree, i: int) -> None:
    """flax WeightNorm(nn.Conv) as the parent's Conv_i + WeightNorm_i → a
    weight-normed torch conv (weight_v (out, in, k), weight_g (out, 1, 1))."""
    _conv(sd, p, {"Conv_0": tree[f"Conv_{i}"],
                  "WeightNorm_0": {"Conv_0/kernel/scale":
                                   tree[f"WeightNorm_{i}"][f"Conv_{i}/kernel/scale"]}})


def vocos_resnet_backbone_state_dict(variables) -> StateDict:
    """JAX VocosResNetBackbone variables → ttts_tpu_torch.models.vocos.
    VocosResNetBackbone state dict, under the reference's attribute names
    (vocoder/models.py: embed, resnet.{i}.convs1/convs2/gamma, each gamma
    (dim, 1)); no released checkpoint was checked against them."""
    p = variables["params"]
    sd: StateDict = {}
    _wn_conv(sd, "embed", p, 0)
    for i in range(_count(p, "VocosResBlock1_")):
        blk, bp = p[f"VocosResBlock1_{i}"], f"resnet.{i}"
        gammas = sorted((k for k in blk if k.startswith("gamma_")), key=lambda k: int(k[6:]))
        for j, g in enumerate(gammas):
            _wn_conv(sd, f"{bp}.convs1.{j}", blk, 2 * j)
            _wn_conv(sd, f"{bp}.convs2.{j}", blk, 2 * j + 1)
            sd[f"{bp}.gamma.{j}"] = _a(blk[g])[:, None]
    return sd


def imdct_head_state_dict(variables) -> StateDict:
    """JAX IMDCTSymExpHead / IMDCTCosHead variables → the port's head
    (`out`, the reference's attribute)."""
    sd: StateDict = {}
    _dense(sd, "out", variables["params"]["Dense_0"])
    return sd


# ------------------------------------------------- classifier, conditioning


def classifier_state_dict(variables) -> StateDict:
    """JAX AudioMiniEncoderWithClassifierHead variables → ttts_tpu_torch.
    models.classifier state dict, under the reference's attribute names
    (ttts/classifier/model.py: enc.init, enc.res = resnet blocks and
    Downsample ops, enc.final, enc.attn, head); no released checkpoint was
    checked against them."""
    p = variables["params"]
    enc = p["AudioMiniEncoder_0"]
    sd: StateDict = {}
    _conv_flax(sd, "enc.init.0", enc["Conv_0"])
    depth = _count(enc, "Conv_") - 1
    per = _count(enc, "ClassifierResBlock_") // depth
    for d in range(depth):
        for r in range(per):
            blk, bp = enc[f"ClassifierResBlock_{d * per + r}"], f"enc.res.{d * (per + 1) + r}"
            _norm(sd, bp + ".in_layers.0", blk["GroupNorm32_0"]["GroupNorm_0"])
            _conv_flax(sd, bp + ".in_layers.2", blk["Conv_0"])
            _norm(sd, bp + ".out_layers.0", blk["GroupNorm32_1"]["GroupNorm_0"])
            _conv_flax(sd, bp + ".out_layers.3", blk["Conv_1"])
        _conv_flax(sd, f"enc.res.{d * (per + 1) + per}.op", enc[f"Conv_{d + 1}"])
    _norm(sd, "enc.final.0", enc["GroupNorm32_0"]["GroupNorm_0"])
    _dense_as_conv1x1(sd, "enc.final.2", enc["Dense_0"])
    for i in range(_count(enc, "AttentionBlock_")):
        _attn_block(sd, f"enc.attn.{i}", enc[f"AttentionBlock_{i}"])
    _dense(sd, "head", p["Dense_0"])
    return sd


def conditioning_encoder_state_dict(variables) -> StateDict:
    """JAX ConditioningEncoder variables → ttts_tpu_torch.models.conditioning.
    ConditioningEncoder (init, attn.{i}; the reference's attribute names, no
    released checkpoint checked against them)."""
    p = variables["params"]
    sd: StateDict = {}
    _conv_flax(sd, "init", p["Conv_0"])
    for i in range(_count(p, "AttentionBlock_")):
        _attn_block(sd, f"attn.{i}", p[f"AttentionBlock_{i}"])
    return sd


def mel_encoder_state_dict(variables) -> StateDict:
    """JAX MelEncoder variables → ttts_tpu_torch.models.conditioning.
    MelEncoder (`encoder`, the reference's nn.Sequential: convs at 0, 2, 6,
    GroupNorms at 3, 7, ResBlock stacks at 1, 5, 9; no released checkpoint
    checked against it)."""
    p = variables["params"]
    n = _count(p, "_MelResBlock_") // 3
    sd: StateDict = {}
    for j, slot in enumerate((0, 2, 6)):
        _conv_flax(sd, f"encoder.{slot}", p[f"Conv_{j}"])
    for j, slot in enumerate((3, 7)):
        _norm(sd, f"encoder.{slot}", p[f"GroupNorm32_{j}"]["GroupNorm_0"])
    for j, slot in enumerate((1, 5, 9)):
        for r in range(n):
            blk, bp = p[f"_MelResBlock_{j * n + r}"], f"encoder.{slot}.{r}.net"
            _conv_flax(sd, bp + ".0", blk["Conv_0"])
            _norm(sd, bp + ".1", blk["GroupNorm32_0"]["GroupNorm_0"])
            _conv_flax(sd, bp + ".3", blk["Conv_1"])
            _norm(sd, bp + ".4", blk["GroupNorm32_1"]["GroupNorm_0"])
    return sd


def perceiver_resampler_state_dict(variables) -> StateDict:
    """JAX PerceiverResampler variables → ttts_tpu_torch.models.conditioning.
    PerceiverResampler (latents; layers.{i}.0 attention with to_kv = [k; v];
    layers.{i}.1 feed-forward; norm). No released checkpoint was checked
    against these names."""
    p = variables["params"]
    depth = _count(p, "Dense_") // 6
    sd: StateDict = {"latents": _a(p["latents"])}
    for i in range(depth):
        d = lambda j: p[f"Dense_{6 * i + j}"]  # noqa: E731
        ln = lambda j: p[f"LayerNorm_{3 * i + j}"]  # noqa: E731
        ap, fp = f"layers.{i}.0", f"layers.{i}.1"
        _norm(sd, ap + ".norm_latents", ln(0))
        _norm(sd, ap + ".norm_context", ln(1))
        sd[ap + ".to_q.weight"] = _a(d(0)["kernel"]).T
        sd[ap + ".to_kv.weight"] = np.concatenate([_a(d(1)["kernel"]).T,
                                                   _a(d(2)["kernel"]).T])
        sd[ap + ".to_out.weight"] = _a(d(3)["kernel"]).T
        _norm(sd, fp + ".norm", ln(2))
        _dense(sd, fp + ".net.0", d(4))
        _dense(sd, fp + ".net.2", d(5))
    _norm(sd, "norm", p[f"LayerNorm_{3 * depth}"])
    return sd


# ------------------------------------------------------------- discriminator


def _wn_conv2d(sd: StateDict, p: str, conv, scale) -> None:
    """flax WeightNorm(nn.Conv) with a (k, 1) kernel (k, 1, in, out) and its
    scale (out,) → weight_v (out, in, k, 1), weight_g (out, 1, 1, 1)."""
    sd[p + ".weight_v"] = _a(conv["kernel"]).transpose(3, 2, 0, 1)
    sd[p + ".weight_g"] = _a(scale).reshape(-1, 1, 1, 1)
    _bias(sd, p, conv)


def discriminator_state_dict(variables) -> StateDict:
    """JAX MultiPeriodDiscriminator variables → the state dict of
    ttts_tpu_torch.models.discriminator.MultiPeriodDiscriminator
    (discriminators.0 the scale discriminator, discriminators.{1+i} the
    period discriminators in order)."""
    params = variables["params"] if "params" in variables else variables
    sd: StateDict = {}
    ds = params["DiscriminatorS_0"]
    n = _count(ds, "Conv1d_")
    for j in range(n - 1):
        _conv(sd, f"discriminators.0.convs.{j}", ds[f"Conv1d_{j}"])
    _conv(sd, "discriminators.0.conv_post", ds[f"Conv1d_{n - 1}"])
    for i in range(_count(params, "DiscriminatorP_")):
        dp, pre = params[f"DiscriminatorP_{i}"], f"discriminators.{i + 1}"
        n = _count(dp, "Conv_")
        for j in range(n):
            name = f"{pre}.convs.{j}" if j < n - 1 else f"{pre}.conv_post"
            _wn_conv2d(sd, name, dp[f"Conv_{j}"],
                       dp[f"WeightNorm_{j}"][f"Conv_{j}/kernel/scale"])
    return sd


# ---------------------------------------------------------------------- rvq1


def _mrte1(sd: StateDict, p: str, tree) -> None:
    _dense_as_conv1x1(sd, p + ".ge_enc.0", tree["Dense_0"])
    _conv_flax(sd, p + ".mel_enc.0", tree["Conv_0"])
    _conv(sd, p + ".text_pre.0", tree["Conv1d_0"])
    for i, name in enumerate(("conv_q", "conv_k", "conv_v", "conv_o")):
        _dense_as_conv1x1(sd, f"{p}.cross_attention.{name}", tree[f"Dense_{i + 1}"])
    _conv(sd, p + ".c_post", tree["Conv1d_1"])


def _rvq1_text_encoder(sd: StateDict, p: str, tree) -> None:
    """RVQ1TextEncoder: AttentionBlock_0..n-1 are enc1.1.., n..2n-1 enc2.*."""
    n = _count(tree, "AttentionBlock_") // 2
    _conv_flax(sd, p + ".enc1.0", tree["Conv_0"])
    sd[p + ".latents"] = _a(tree["latents"])
    for i in range(n):
        _attn_block(sd, f"{p}.enc1.{i + 1}", tree[f"AttentionBlock_{i}"])
        _attn_block(sd, f"{p}.enc2.{i}", tree[f"AttentionBlock_{n + i}"])
    _mrte1(sd, p + ".mrte", tree["MRTE1_0"])
    _conv(sd, p + ".proj", tree["Conv1d_0"])


def _wn_encoder(sd: StateDict, p: str, tree) -> None:
    _conv(sd, p + ".in_proj", tree["Conv1d_0"])
    _wn(sd, p + ".enc", tree["WN_0"])
    _conv(sd, p + ".proj", tree["Conv1d_1"])


def rvq1_state_dict(variables) -> StateDict:
    """JAX RVQ1 variables {'params', 'codebook'} → the state dict of
    ttts_tpu_torch.models.rvq1.RVQ1 (inverse of port_rvq1_state, but for
    dec's transposed convolutions, as the codec's)."""
    p = variables["params"]
    sd: StateDict = {}
    _conv(sd, "semantic_proj", p["semantic_proj"])
    _rvq1_text_encoder(sd, "text_enc", p["text_enc"])
    _wn_encoder(sd, "semantic_enc", p["semantic_enc"])
    _wn_encoder(sd, "spec_enc", p["spec_enc"])
    _generator(sd, "dec", p["dec"])
    _coupling_flow(sd, "flow", p["flow"])
    _conv(sd, "ref_enc.0", p["ref_pre"])
    _ref_encoder(sd, "ref_enc.1", p["ref_enc"])
    _codebook(sd, "quantizer", variables["codebook"]["quantizer"]["state"])
    return sd


# ---------------------------------------------------------------------- dvae


def _dvae_resblock(sd: StateDict, p: str, tree) -> None:
    _conv_flax(sd, p + ".net.0", tree["Conv_0"])
    _conv_flax(sd, p + ".net.2", tree["Conv_1"])


def dvae_state_dict(variables) -> StateDict:
    """JAX DiscreteVAE variables {'params', 'codebook'} → the state dict of
    ttts_tpu_torch.models.dvae.DiscreteVAE."""
    p = variables["params"]
    sd: StateDict = {}
    enc, dec = p["encoder"], p["decoder"]
    n_res = _count(enc, "_ResBlock_")
    n_down = _count(enc, "Conv1d_") - 1
    for i in range(n_down):
        _conv(sd, f"encoder.{i}.0", enc[f"Conv1d_{i}"])
    for j in range(n_res):
        _dvae_resblock(sd, f"encoder.{n_down + j}", enc[f"_ResBlock_{j}"])
    _conv(sd, f"encoder.{n_down + n_res}", enc[f"Conv1d_{n_down}"])
    base = 0
    if n_res:
        _conv(sd, "decoder.0", dec["Conv1d_0"])
        for j in range(n_res):
            _dvae_resblock(sd, f"decoder.{1 + j}", dec[f"_ResBlock_{j}"])
        base = 1 + n_res
    for i in range(n_down):
        _conv_transpose(sd, f"decoder.{base + i}.0", dec[f"ConvTranspose1d_{i}"])
    _conv(sd, f"decoder.{base + n_down}", dec[f"Conv1d_{1 if n_res else 0}"])
    _codebook(sd, "quantizer", variables["codebook"]["quantizer"]["state"])
    return sd


# ----------------------------------------------------------- group quantizer


def group_quantizer_state_dict(variables) -> StateDict:
    """JAX GroupQuantizer variables → ttts_tpu_torch.models.group_quantizer.
    GroupQuantizer state dict: each group's codebook an embedding,
    quantizer_modules.{i}.embedding.weight (vq2.py Quantizer_module)."""
    cbs = _a(variables["params"]["codebooks"])
    return {f"quantizer_modules.{i}.embedding.weight": cbs[i] for i in range(cbs.shape[0])}


# ------------------------------------------------------------ blocks extras


def mel_style_encoder_vae_state_dict(variables) -> StateDict:
    """JAX MelStyleEncoderVAE variables → the port's (ref_encoder, fc1-3)."""
    p = variables["params"]
    sd: StateDict = {}
    _mel_style_encoder(sd, "ref_encoder", p["ref_encoder"])
    for name in ("fc1", "fc2", "fc3"):
        _dense(sd, name, p[name])
    return sd


def transformer_decoder_state_dict(variables) -> StateDict:
    """JAX TransformerDecoder variables → the port's (attentions.Decoder's
    keys): per layer i, RelPosMultiHeadAttention_{2i} the causal
    self-attention, _{2i+1} the attention to the memory, LayerNorm_{3i..3i+2}
    and Conv1d_{2i}, _{2i+1} the FFN."""
    p = variables["params"]
    sd: StateDict = {}
    for i in range(_count(p, "RelPosMultiHeadAttention_") // 2):
        _vits_mha(sd, f"self_attn_layers.{i}", p[f"RelPosMultiHeadAttention_{2 * i}"])
        _vits_mha(sd, f"encdec_attn_layers.{i}", p[f"RelPosMultiHeadAttention_{2 * i + 1}"])
        for j in range(3):
            _layernorm(sd, f"norm_layers_{j}.{i}", p[f"LayerNorm_{3 * i + j}"])
        _conv(sd, f"ffn_layers.{i}.conv_1", p[f"Conv1d_{2 * i}"])
        _conv(sd, f"ffn_layers.{i}.conv_2", p[f"Conv1d_{2 * i + 1}"])
    return sd


# --------------------------------------------------------------------- flows


def _ddsconv(sd: StateDict, p: str, tree) -> None:
    for i in range(_count(tree, "Conv1d_") // 2):
        _conv(sd, f"{p}convs_sep.{i}", tree[f"Conv1d_{2 * i}"])
        _layernorm(sd, f"{p}norms_1.{i}", tree[f"LayerNorm_{2 * i}"])
        _conv(sd, f"{p}convs_1x1.{i}", tree[f"Conv1d_{2 * i + 1}"])
        _layernorm(sd, f"{p}norms_2.{i}", tree[f"LayerNorm_{2 * i + 1}"])


def flow_state_dict(variables) -> StateDict:
    """JAX variables of one module of models/flows.py → the port's state
    dict, the module told by its parameters: ElementwiseAffine {m, logs}
    → (C, 1) each; ActNorm {logs, bias} → (1, C, 1); InvConvNear {weight};
    DDSConv; ConvFlow {Conv1d_0 pre, DDSConv_0 convs, Dense_0 proj}."""
    p = variables["params"]
    if "m" in p:
        return {"m": _a(p["m"])[:, None], "logs": _a(p["logs"])[:, None]}
    if "logs" in p:
        return {"logs": _a(p["logs"])[None, :, None], "bias": _a(p["bias"])[None, :, None]}
    if "weight" in p:
        return {"weight": _a(p["weight"])}
    sd: StateDict = {}
    if "DDSConv_0" in p:
        _conv(sd, "pre", p["Conv1d_0"])
        _ddsconv(sd, "convs.", p["DDSConv_0"])
        _dense_as_conv1x1(sd, "proj", p["Dense_0"])
    else:
        _ddsconv(sd, "", p)
    return sd


# -------------------------------------------------------- attentions extras


def depthwise_separable_conv_state_dict(variables) -> StateDict:
    """JAX DepthwiseSeparableConv1d / ...ConvTranspose1d variables → the
    port's (depth_conv, point_conv); the transposed depthwise kernel (k, 1,
    C) → torch's (C, 1, k), its weight norm g (C,) → weight_g (C, 1, 1)."""
    p = variables["params"]
    sd: StateDict = {}
    if "depth_kernel" not in p:
        _conv(sd, "depth_conv", p["Conv1d_0"])
        _conv(sd, "point_conv", p["Conv1d_1"])
        return sd
    w = _a(p["depth_kernel"]).transpose(2, 1, 0)
    if "depth_g" in p:
        sd["depth_conv.weight_v"] = w
        sd["depth_conv.weight_g"] = _a(p["depth_g"]).reshape(-1, 1, 1)
    else:
        sd["depth_conv.weight"] = w
    if "depth_bias" in p:
        sd["depth_conv.bias"] = _a(p["depth_bias"])
    _conv(sd, "point_conv", p["Conv1d_0"])
    return sd


def _flow_cond(sd: StateDict, p: str, tree) -> None:
    _conv(sd, p + "cond_layer", tree["Conv1d_0"])
    _conv(sd, p + "cond_pre", tree["cond_pre"])


def fft_state_dict(variables) -> StateDict:
    """JAX FFT variables → the port's (the inverse of port_fft_state)."""
    p = variables["params"]
    sd: StateDict = {}
    base = 1 if "cond_pre" in p else 0
    if base:
        _flow_cond(sd, "", p)
    for i in range(_count(p, "RelPosMultiHeadAttention_")):
        _vits_mha(sd, f"self_attn_layers.{i}", p[f"RelPosMultiHeadAttention_{i}"])
        _layernorm(sd, f"norm_layers_0.{i}", p[f"LayerNorm_{2 * i}"])
        _conv(sd, f"ffn_layers.{i}.conv_1", p[f"Conv1d_{base + 2 * i}"])
        _conv(sd, f"ffn_layers.{i}.conv_2", p[f"Conv1d_{base + 2 * i + 1}"])
        _layernorm(sd, f"norm_layers_1.{i}", p[f"LayerNorm_{2 * i + 1}"])
    return sd


def transformer_coupling_state_dict(variables) -> StateDict:
    """JAX TransformerCouplingLayer variables → the port's (the inverse of
    port_transformer_coupling_state)."""
    p = variables["params"]
    sd: StateDict = {}
    _conv(sd, "pre", p["Conv1d_0"])
    enc = p["FlowConditionedEncoder_0"]
    _flow_cond(sd, "enc.", enc)
    _vits_encoder(sd, "enc", enc)
    _conv_flax(sd, "post", p["post"])
    return sd


STATE_DICT_FNS = {
    "codec": synthesizer_trn_state_dict,
    "gpt": unified_voice_state_dict,
    "diffusion": aa_diffusion_state_dict,
    "vocos": vocos_state_dict,
    "clvp": clvp_state_dict,
    "classifier": classifier_state_dict,
    "discriminator": discriminator_state_dict,
    "rvq1": rvq1_state_dict,
    "dvae": dvae_state_dict,
    "group_quantizer": group_quantizer_state_dict,
    "mel_style_encoder_vae": mel_style_encoder_vae_state_dict,
    "transformer_decoder": transformer_decoder_state_dict,
    "flow": flow_state_dict,
    "depthwise_separable_conv": depthwise_separable_conv_state_dict,
    "fft": fft_state_dict,
    "transformer_coupling": transformer_coupling_state_dict,
}


# ----------------------------------------------- state dict → JAX variables


def _np(v) -> np.ndarray:
    if hasattr(v, "detach"):
        v = v.detach().cpu().float().numpy()
    return np.array(v, dtype=np.float32)


def _inv_norm(sd, p: str) -> dict:
    return {"scale": _np(sd[p + ".weight"]), "bias": _np(sd[p + ".bias"])}


def _inv_dense(sd, p: str) -> dict:
    return {"kernel": _np(sd[p + ".weight"]).T, "bias": _np(sd[p + ".bias"])}


def _inv_dense_as_conv1x1(sd, p: str) -> dict:
    return {"kernel": _np(sd[p + ".weight"])[:, :, 0].T, "bias": _np(sd[p + ".bias"])}


def _inv_conv_flax(sd, p: str) -> dict:
    return {"kernel": _np(sd[p + ".weight"]).transpose(2, 1, 0), "bias": _np(sd[p + ".bias"])}


def _indices(sd, prefix: str) -> range:
    """range(n) for the n sub-modules `prefix{i}.` of the state dict."""
    idx = {int(k[len(prefix):].split(".")[0]) for k in sd if k.startswith(prefix)}
    return range(len(idx))


def unified_voice_variables(sd) -> dict:
    """ttts_tpu_torch UnifiedVoice state dict → JAX UnifiedVoice variables;
    the inverse of unified_voice_state_dict."""
    stack = {"ln_f": _inv_norm(sd, "gpt.ln_f")}
    for i in _indices(sd, "gpt.h."):
        pre = f"gpt.h.{i}"
        blk = {"LayerNorm_0": _inv_norm(sd, pre + ".ln_1"),
               "LayerNorm_1": _inv_norm(sd, pre + ".ln_2")}
        for name, dense in (("attn.c_attn", "Dense_0"), ("attn.c_proj", "Dense_1"),
                            ("mlp.c_fc", "Dense_2"), ("mlp.c_proj", "Dense_3")):
            blk[dense] = {"kernel": _np(sd[f"{pre}.{name}.weight"]),
                          "bias": _np(sd[f"{pre}.{name}.bias"])}
        stack[f"GPT2Block_{i}"] = blk
    return {"params": {
        "text_embedding": {"embedding": _np(sd["text_embedding.weight"])},
        "mel_embedding": {"embedding": _np(sd["mel_embedding.weight"])},
        "text_pos_embedding": _np(sd["text_pos_embedding.emb.weight"]),
        "mel_pos_embedding": _np(sd["mel_pos_embedding.emb.weight"]),
        "final_norm": _inv_norm(sd, "final_norm"),
        "text_head": _inv_dense(sd, "text_head"),
        "mel_head": _inv_dense(sd, "mel_head"),
        "gpt": stack}}


def _inv_attn_block(sd, p: str) -> dict:
    tree = {"norm": {"GroupNorm_0": _inv_norm(sd, p + ".norm")},
            "qkv": _inv_dense_as_conv1x1(sd, p + ".qkv"),
            "proj": _inv_dense_as_conv1x1(sd, p + ".proj_out")}
    rel = p + ".relative_pos_embeddings.relative_attention_bias.weight"
    if rel in sd:
        tree["relpos"] = {"table": {"embedding": _np(sd[rel])}}
    return tree


def _inv_ss_resblock(sd, p: str) -> dict:
    return {"GroupNorm32_0": {"GroupNorm_0": _inv_norm(sd, p + ".in_layers.0")},
            "Dense_0": _inv_dense_as_conv1x1(sd, p + ".in_layers.2"),
            "Dense_1": _inv_dense(sd, p + ".emb_layers.1"),
            "GroupNorm32_1": {"GroupNorm_0": _inv_norm(sd, p + ".out_layers.0")},
            "Conv_0": _inv_conv_flax(sd, p + ".out_layers.3")}


def _inv_diffusion_layer(sd, p: str) -> dict:
    return {"resblk": _inv_ss_resblock(sd, p + ".resblk"),
            "attn": _inv_attn_block(sd, p + ".attn")}


def aa_diffusion_variables(sd) -> dict:
    """ttts_tpu_torch AA_diffusion state dict → JAX AA_diffusion variables;
    the inverse of aa_diffusion_state_dict."""
    p = {"inp_block": _inv_conv_flax(sd, "inp_block"),
         "time_embed_0": _inv_dense(sd, "time_embed.0"),
         "time_embed_1": _inv_dense(sd, "time_embed.2"),
         "unconditioned_embedding": _np(sd["unconditioned_embedding"]).transpose(0, 2, 1),
         "integrating_conv": _inv_dense_as_conv1x1(sd, "integrating_conv"),
         "out_norm": {"GroupNorm_0": _inv_norm(sd, "out.0")},
         "out_conv": _inv_conv_flax(sd, "out.2"),
         "code_norm": {"GroupNorm_0": _inv_norm(sd, "code_norm")},
         "latent_conditioner_0": _inv_conv_flax(sd, "latent_conditioner.0"),
         "refer_conv": _inv_conv_flax(sd, "refer_enc.0")}
    for i in range(3):
        p[f"conditioning_timestep_integrator_{i}"] = _inv_diffusion_layer(
            sd, f"conditioning_timestep_integrator.{i}")
        p[f"latent_conditioner_{i + 1}"] = _inv_attn_block(sd, f"latent_conditioner.{i + 1}")
        p[f"refer_attn_{i}"] = _inv_attn_block(sd, f"refer_enc.{i + 1}")
    for i in _indices(sd, "layers."):
        pre = f"layers.{i}"
        p[f"layers_{i}"] = (_inv_diffusion_layer(sd, pre) if pre + ".attn.qkv.weight" in sd
                            else _inv_ss_resblock(sd, pre))
    p["refer_pool"] = _inv_ref_encoder(sd, "refer_enc.4")
    return {"params": p}


def _inv_ref_encoder(sd, p: str) -> dict:
    """The inverse of _ref_encoder: latents, the cross-attention Denses,
    the conv and the AttentionBlocks."""
    tree = {"latents": _np(sd[p + ".latents"]), "Conv_0": _inv_conv_flax(sd, p + ".enc.0")}
    for i, name in enumerate(("conv_q", "conv_k", "conv_v", "conv_o")):
        tree[f"Dense_{i}"] = _inv_dense_as_conv1x1(sd, f"{p}.cross_attention.{name}")
    for i in range(len(_indices(sd, p + ".enc.")) - 1):
        tree[f"AttentionBlock_{i}"] = _inv_attn_block(sd, f"{p}.enc.{i + 1}")
    return tree


# ----------------------------------------------- codec and discriminator


def _inv_bias(sd, p: str, tree: dict) -> dict:
    if p + ".bias" in sd:
        tree["bias"] = _np(sd[p + ".bias"])
    return tree


def _inv_conv(sd, p: str) -> dict:
    """The inverse of _conv: a blocks.Conv1d subtree."""
    if p + ".weight_v" in sd:
        kernel = _np(sd[p + ".weight_v"]).transpose(2, 1, 0)
        return {"Conv_0": _inv_bias(sd, p, {"kernel": kernel}),
                "WeightNorm_0": {"Conv_0/kernel/scale": _np(sd[p + ".weight_g"]).reshape(-1)}}
    return {"Conv_0": _inv_bias(sd, p, {"kernel": _np(sd[p + ".weight"]).transpose(2, 1, 0)})}


def _inv_linear_as_conv1x1(sd, p: str) -> dict:
    """The inverse of _conv1x1_as_linear."""
    return {"Conv_0": _inv_bias(sd, p, {"kernel": _np(sd[p + ".weight"]).T[None]})}


def _inv_wn(sd, p: str) -> dict:
    tree, base = {}, 0
    if p + ".cond_layer.weight_v" in sd:
        tree["Conv1d_0"], base = _inv_conv(sd, p + ".cond_layer"), 1
    for i in _indices(sd, p + ".in_layers."):
        tree[f"Conv1d_{base + 2 * i}"] = _inv_conv(sd, f"{p}.in_layers.{i}")
        tree[f"Conv1d_{base + 2 * i + 1}"] = _inv_conv(sd, f"{p}.res_skip_layers.{i}")
    return tree


def _inv_resblock1(sd, p: str) -> dict:
    tree = {}
    for j in _indices(sd, p + ".convs1."):
        tree[f"Conv1d_{2 * j}"] = _inv_conv(sd, f"{p}.convs1.{j}")
        tree[f"Conv1d_{2 * j + 1}"] = _inv_conv(sd, f"{p}.convs2.{j}")
    return tree


def _inv_mel_style_encoder(sd, p: str) -> dict:
    att = {f"Conv1d_{i}": _inv_linear_as_conv1x1(sd, f"{p}.slf_attn.{name}")
           for i, name in enumerate(("w_qs", "w_ks", "w_vs", "fc"))}
    return {"Dense_0": _inv_dense(sd, p + ".spectral.0.fc"),
            "Dense_1": _inv_dense(sd, p + ".spectral.3.fc"),
            "Conv1dGLU_0": {"Conv1d_0": _inv_conv(sd, p + ".temporal.0.conv1.conv")},
            "Conv1dGLU_1": {"Conv1d_0": _inv_conv(sd, p + ".temporal.1.conv1.conv")},
            "RelPosMultiHeadAttention_0": att,
            "Dense_2": _inv_dense(sd, p + ".fc.fc")}


def _inv_posterior_audio_encoder(sd, p: str) -> dict:
    n_down = len(_indices(sd, p + ".downs."))
    tree = {"Conv1d_0": _inv_conv(sd, p + ".down_pre")}
    for i in range(n_down):
        tree[f"Conv1d_{i + 1}"] = _inv_conv(sd, f"{p}.downs.{i}")
    for k in _indices(sd, p + ".resblocks."):
        tree[f"ResBlock1_{k}"] = _inv_resblock1(sd, f"{p}.resblocks.{k}")
    tree["AntiAliasedActivation_0"] = {"SnakeBeta_0": {
        "log_alpha": _np(sd[p + ".activation_post.act.alpha"]),
        "log_beta": _np(sd[p + ".activation_post.act.beta"])}}
    tree[f"Conv1d_{n_down + 1}"] = _inv_conv(sd, p + ".conv_post")
    tree[f"Conv1d_{n_down + 2}"] = _inv_conv(sd, p + ".pre")
    tree["WN_0"] = _inv_wn(sd, p + ".enc")
    tree[f"Conv1d_{n_down + 3}"] = _inv_conv(sd, p + ".proj")
    return tree


def _inv_vits_mha(sd, p: str) -> dict:
    tree = {f"Conv1d_{i}": _inv_conv(sd, f"{p}.{name}")
            for i, name in enumerate(("conv_q", "conv_k", "conv_v", "conv_o"))}
    for name in ("emb_rel_k", "emb_rel_v"):
        if f"{p}.{name}" in sd:
            tree[name] = _np(sd[f"{p}.{name}"])
    return tree


def _inv_vits_encoder(sd, p: str) -> dict:
    tree = {}
    ln = lambda q: {"scale": _np(sd[q + ".gamma"]), "bias": _np(sd[q + ".beta"])}  # noqa: E731
    for i in _indices(sd, p + ".attn_layers."):
        tree[f"RelPosMultiHeadAttention_{i}"] = _inv_vits_mha(sd, f"{p}.attn_layers.{i}")
        tree[f"LayerNorm_{2 * i}"] = ln(f"{p}.norm_layers_1.{i}")
        tree[f"ConvFFN_{i}"] = {"Conv1d_0": _inv_conv(sd, f"{p}.ffn_layers.{i}.conv_1"),
                                "Conv1d_1": _inv_conv(sd, f"{p}.ffn_layers.{i}.conv_2")}
        tree[f"LayerNorm_{2 * i + 1}"] = ln(f"{p}.norm_layers_2.{i}")
    return tree


def _inv_text_encoder(sd, p: str) -> dict:
    return {"TransformerEncoder_0": _inv_vits_encoder(sd, p + ".encoder_ssl"),
            "Embed_0": {"embedding": _np(sd[p + ".text_embedding.weight"])},
            "TransformerEncoder_1": _inv_vits_encoder(sd, p + ".encoder_text"),
            "MRTE_0": {"Conv1d_0": _inv_conv(sd, p + ".mrte.c_pre"),
                       "Conv1d_1": _inv_conv(sd, p + ".mrte.text_pre"),
                       "RelPosMultiHeadAttention_0": _inv_vits_mha(
                           sd, p + ".mrte.cross_attention"),
                       "Conv1d_2": _inv_conv(sd, p + ".mrte.c_post")},
            "TransformerEncoder_2": _inv_vits_encoder(sd, p + ".encoder2"),
            "Conv1d_0": _inv_conv(sd, p + ".proj")}


def _inv_coupling_flow(sd, p: str) -> dict:
    return {f"ResidualCouplingLayer_{i}": {
        "Conv1d_0": _inv_conv(sd, f"{p}.flows.{2 * i}.pre"),
        "WN_0": _inv_wn(sd, f"{p}.flows.{2 * i}.enc"),
        "Dense_0": _inv_dense_as_conv1x1(sd, f"{p}.flows.{2 * i}.post")}
        for i in _indices(sd, p + ".flows.")}  # flows.{2i + 1}, the flips, hold no keys


def _inv_conv_transpose(sd, p: str) -> dict:
    """The inverse of _conv_transpose, a relayout."""
    if p + ".weight" in sd:
        return _inv_bias(sd, p, {"kernel": _np(sd[p + ".weight"]).transpose(2, 0, 1)})
    tree = {"kernel": _np(sd[p + ".weight_v"]).transpose(2, 0, 1),
            "g": _np(sd[p + ".weight_g"]).reshape(-1)}
    return _inv_bias(sd, p, tree)


def _inv_generator(sd, p: str) -> dict:
    tree = {"Conv1d_0": _inv_conv(sd, p + ".conv_pre"), "Conv1d_1": _inv_conv(sd, p + ".cond"),
            "Conv1d_2": _inv_conv(sd, p + ".conv_post")}
    for i in _indices(sd, p + ".ups."):
        tree[f"ConvTranspose1d_{i}"] = _inv_conv_transpose(sd, f"{p}.ups.{i}")
    for k in _indices(sd, p + ".resblocks."):
        tree[f"ResBlock1_{k}"] = _inv_resblock1(sd, f"{p}.resblocks.{k}")
    return tree


def synthesizer_trn_variables(sd) -> dict:
    """ttts_tpu_torch SynthesizerTrn state dict (serving or training) → JAX
    SynthesizerTrn variables {'params', 'codebook'}; the inverse of
    synthesizer_trn_state_dict (enc_q when the state dict has it)."""
    params = {"ref_enc": _inv_mel_style_encoder(sd, "ref_enc"),
              "enc_p": _inv_posterior_audio_encoder(sd, "enc_p"),
              "enc_p_2": _inv_text_encoder(sd, "enc_p_2"),
              "flow": _inv_coupling_flow(sd, "flow"),
              "dec": _inv_generator(sd, "dec"),
              "proj": _inv_conv(sd, "proj")}
    if any(k.startswith("enc_q.") for k in sd):
        params["enc_q"] = _inv_posterior_audio_encoder(sd, "enc_q")
    return {"params": params, "codebook": {"quantizer": {"state": _inv_codebook(sd, "quantizer")}}}


def _inv_codebook(sd, p: str) -> dict:
    """The inverse of _codebook: the RVQState fields as a dict."""
    layers = _indices(sd, p + ".vq.layers.")
    cb = lambda k: np.stack([_np(sd[f"{p}.vq.layers.{i}._codebook.{k}"])  # noqa: E731
                             for i in layers])
    return {"embed": cb("embed"), "embed_avg": cb("embed_avg"),
            "cluster_size": cb("cluster_size"),
            "inited": np.asarray(bool(_np(sd[f"{p}.vq.layers.0._codebook.inited"])[0]))}


def _inv_wn_encoder(sd, p: str) -> dict:
    return {"Conv1d_0": _inv_conv(sd, p + ".in_proj"), "WN_0": _inv_wn(sd, p + ".enc"),
            "Conv1d_1": _inv_conv(sd, p + ".proj")}


def _inv_rvq1_text_encoder(sd, p: str) -> dict:
    n = len(_indices(sd, p + ".enc2."))
    m = p + ".mrte"
    mrte = {"Dense_0": _inv_dense_as_conv1x1(sd, m + ".ge_enc.0"),
            "Conv_0": _inv_conv_flax(sd, m + ".mel_enc.0"),
            "Conv1d_0": _inv_conv(sd, m + ".text_pre.0"),
            "Conv1d_1": _inv_conv(sd, m + ".c_post")}
    for i, name in enumerate(("conv_q", "conv_k", "conv_v", "conv_o")):
        mrte[f"Dense_{i + 1}"] = _inv_dense_as_conv1x1(sd, f"{m}.cross_attention.{name}")
    tree = {"Conv_0": _inv_conv_flax(sd, p + ".enc1.0"), "latents": _np(sd[p + ".latents"]),
            "MRTE1_0": mrte, "Conv1d_0": _inv_conv(sd, p + ".proj")}
    for i in range(n):
        tree[f"AttentionBlock_{i}"] = _inv_attn_block(sd, f"{p}.enc1.{i + 1}")
        tree[f"AttentionBlock_{n + i}"] = _inv_attn_block(sd, f"{p}.enc2.{i}")
    return tree


def dvae_variables(sd) -> dict:
    """ttts_tpu_torch DiscreteVAE state dict → JAX DiscreteVAE variables;
    the inverse of dvae_state_dict."""
    res = lambda q: {"Conv_0": _inv_conv_flax(sd, q + ".net.0"),  # noqa: E731
                     "Conv_1": _inv_conv_flax(sd, q + ".net.2")}
    enc_idx = _indices(sd, "encoder.")
    n_down = sum(f"encoder.{i}.0.weight" in sd for i in enc_idx)
    n_res = sum(f"encoder.{i}.net.0.weight" in sd for i in enc_idx)
    enc = {f"Conv1d_{i}": _inv_conv(sd, f"encoder.{i}.0") for i in range(n_down)}
    enc.update({f"_ResBlock_{j}": res(f"encoder.{n_down + j}") for j in range(n_res)})
    enc[f"Conv1d_{n_down}"] = _inv_conv(sd, f"encoder.{n_down + n_res}")
    dec, base = {}, 0
    if n_res:
        dec["Conv1d_0"] = _inv_conv(sd, "decoder.0")
        dec.update({f"_ResBlock_{j}": res(f"decoder.{1 + j}") for j in range(n_res)})
        base = 1 + n_res
    for i in range(n_down):
        dec[f"ConvTranspose1d_{i}"] = _inv_conv_transpose(sd, f"decoder.{base + i}.0")
    dec[f"Conv1d_{1 if n_res else 0}"] = _inv_conv(sd, f"decoder.{base + n_down}")
    return {"params": {"encoder": enc, "decoder": dec},
            "codebook": {"quantizer": {"state": _inv_codebook(sd, "quantizer")}}}


def group_quantizer_variables(sd) -> dict:
    """The inverse of group_quantizer_state_dict."""
    n = len(_indices(sd, "quantizer_modules."))
    return {"params": {"codebooks": np.stack(
        [_np(sd[f"quantizer_modules.{i}.embedding.weight"]) for i in range(n)])}}


def _inv_layernorm(sd, p: str) -> dict:
    return {"scale": _np(sd[p + ".gamma"]), "bias": _np(sd[p + ".beta"])}


def mel_style_encoder_vae_variables(sd) -> dict:
    """The inverse of mel_style_encoder_vae_state_dict."""
    p = {name: _inv_dense(sd, name) for name in ("fc1", "fc2", "fc3")}
    p["ref_encoder"] = _inv_mel_style_encoder(sd, "ref_encoder")
    return {"params": p}


def transformer_decoder_variables(sd) -> dict:
    """The inverse of transformer_decoder_state_dict."""
    p = {}
    for i in _indices(sd, "self_attn_layers."):
        p[f"RelPosMultiHeadAttention_{2 * i}"] = _inv_vits_mha(sd, f"self_attn_layers.{i}")
        p[f"RelPosMultiHeadAttention_{2 * i + 1}"] = _inv_vits_mha(sd, f"encdec_attn_layers.{i}")
        for j in range(3):
            p[f"LayerNorm_{3 * i + j}"] = _inv_layernorm(sd, f"norm_layers_{j}.{i}")
        p[f"Conv1d_{2 * i}"] = _inv_conv(sd, f"ffn_layers.{i}.conv_1")
        p[f"Conv1d_{2 * i + 1}"] = _inv_conv(sd, f"ffn_layers.{i}.conv_2")
    return {"params": p}


def _inv_ddsconv(sd, p: str) -> dict:
    tree = {}
    for i in _indices(sd, p + "convs_sep."):
        tree[f"Conv1d_{2 * i}"] = _inv_conv(sd, f"{p}convs_sep.{i}")
        tree[f"LayerNorm_{2 * i}"] = _inv_layernorm(sd, f"{p}norms_1.{i}")
        tree[f"Conv1d_{2 * i + 1}"] = _inv_conv(sd, f"{p}convs_1x1.{i}")
        tree[f"LayerNorm_{2 * i + 1}"] = _inv_layernorm(sd, f"{p}norms_2.{i}")
    return tree


def flow_variables(sd) -> dict:
    """The inverse of flow_state_dict."""
    if "m" in sd:
        return {"params": {"m": _np(sd["m"]).reshape(-1), "logs": _np(sd["logs"]).reshape(-1)}}
    if "logs" in sd:
        return {"params": {"logs": _np(sd["logs"]).reshape(-1),
                           "bias": _np(sd["bias"]).reshape(-1)}}
    if "weight" in sd:
        return {"params": {"weight": _np(sd["weight"])}}
    if "pre.weight" in sd:
        return {"params": {"Conv1d_0": _inv_conv(sd, "pre"), "DDSConv_0": _inv_ddsconv(sd, "convs."),
                           "Dense_0": _inv_dense_as_conv1x1(sd, "proj")}}
    return {"params": _inv_ddsconv(sd, "")}


def depthwise_separable_conv_variables(sd, transpose: bool = False) -> dict:
    """The inverse of depthwise_separable_conv_state_dict (`transpose`: of
    the transposed variant, whose depthwise weight has the same shape)."""
    if not transpose:
        return {"params": {"Conv1d_0": _inv_conv(sd, "depth_conv"),
                           "Conv1d_1": _inv_conv(sd, "point_conv")}}
    wn = "depth_conv.weight_v" in sd
    p = {"depth_kernel": _np(sd["depth_conv.weight_v" if wn else "depth_conv.weight"])
         .transpose(2, 1, 0), "Conv1d_0": _inv_conv(sd, "point_conv")}
    if wn:
        p["depth_g"] = _np(sd["depth_conv.weight_g"]).reshape(-1)
    if "depth_conv.bias" in sd:
        p["depth_bias"] = _np(sd["depth_conv.bias"])
    return {"params": p}


def _inv_flow_cond(sd, p: str) -> dict:
    return {"Conv1d_0": _inv_conv(sd, p + "cond_layer"), "cond_pre": _inv_conv(sd, p + "cond_pre")}


def fft_variables(sd) -> dict:
    """The inverse of fft_state_dict."""
    base = 1 if "cond_pre.weight" in sd else 0
    p = _inv_flow_cond(sd, "") if base else {}
    for i in _indices(sd, "self_attn_layers."):
        p[f"RelPosMultiHeadAttention_{i}"] = _inv_vits_mha(sd, f"self_attn_layers.{i}")
        p[f"LayerNorm_{2 * i}"] = _inv_layernorm(sd, f"norm_layers_0.{i}")
        p[f"Conv1d_{base + 2 * i}"] = _inv_conv(sd, f"ffn_layers.{i}.conv_1")
        p[f"Conv1d_{base + 2 * i + 1}"] = _inv_conv(sd, f"ffn_layers.{i}.conv_2")
        p[f"LayerNorm_{2 * i + 1}"] = _inv_layernorm(sd, f"norm_layers_1.{i}")
    return {"params": p}


def transformer_coupling_variables(sd) -> dict:
    """The inverse of transformer_coupling_state_dict."""
    enc = {**_inv_flow_cond(sd, "enc."), **_inv_vits_encoder(sd, "enc")}
    return {"params": {"Conv1d_0": _inv_conv(sd, "pre"), "FlowConditionedEncoder_0": enc,
                       "post": _inv_conv_flax(sd, "post")}}


def rvq1_variables(sd) -> dict:
    """ttts_tpu_torch RVQ1 state dict → JAX RVQ1 variables {'params',
    'codebook'}; the inverse of rvq1_state_dict."""
    params = {"semantic_proj": _inv_conv(sd, "semantic_proj"),
              "text_enc": _inv_rvq1_text_encoder(sd, "text_enc"),
              "semantic_enc": _inv_wn_encoder(sd, "semantic_enc"),
              "spec_enc": _inv_wn_encoder(sd, "spec_enc"),
              "dec": _inv_generator(sd, "dec"),
              "flow": _inv_coupling_flow(sd, "flow"),
              "ref_pre": _inv_conv(sd, "ref_enc.0"),
              "ref_enc": _inv_ref_encoder(sd, "ref_enc.1")}
    return {"params": params, "codebook": {"quantizer": {"state": _inv_codebook(sd, "quantizer")}}}


def discriminator_variables(sd) -> dict:
    """ttts_tpu_torch MultiPeriodDiscriminator state dict → JAX
    MultiPeriodDiscriminator variables; the inverse of
    discriminator_state_dict."""
    pre = "discriminators.0"
    ds = {f"Conv1d_{j}": _inv_conv(sd, f"{pre}.convs.{j}")
          for j in _indices(sd, pre + ".convs.")}
    ds[f"Conv1d_{len(ds)}"] = _inv_conv(sd, pre + ".conv_post")
    params = {"DiscriminatorS_0": ds}
    for i in range(1, len(_indices(sd, "discriminators."))):
        pre, dp = f"discriminators.{i}", {}
        names = [f"{pre}.convs.{j}" for j in _indices(sd, pre + ".convs.")] + [pre + ".conv_post"]
        for j, name in enumerate(names):
            dp[f"Conv_{j}"] = _inv_bias(sd, name, {
                "kernel": _np(sd[name + ".weight_v"]).transpose(2, 3, 1, 0)})
            scale = _np(sd[name + ".weight_g"]).reshape(-1)
            dp[f"WeightNorm_{j}"] = {f"Conv_{j}/kernel/scale": scale}
        params[f"DiscriminatorP_{i - 1}"] = dp
    return {"params": params}


# ------------------------------------------------------- clvp and classifier


def _inv_clvp_encoder(sd, p: str) -> dict:
    layers = p + ".transformer.attn_layers.layers."
    tree = {"LayerNorm_0": _inv_norm(sd, p + ".transformer.norm")}
    for i in range(len(_indices(sd, layers)) // 2):
        ap, fp = f"{layers}{2 * i}", f"{layers}{2 * i + 1}"
        lyr = {"RMSNorm_0": {"scale": _np(sd[ap + ".0.0.g"])},
               "Dense_3": _inv_dense(sd, ap + ".1.wrap.to_out"),
               "RMSNorm_1": {"scale": _np(sd[fp + ".0.0.g"])},
               "Dense_4": _inv_dense(sd, fp + ".1.wrap.net.0.proj"),
               "Dense_5": _inv_dense(sd, fp + ".1.wrap.net.3")}
        for j, name in enumerate(("to_q", "to_k", "to_v")):
            lyr[f"Dense_{j}"] = {"kernel": _np(sd[f"{ap}.1.wrap.{name}.weight"]).T}
        tree[f"EncoderLayer_{i}"] = lyr
    return tree


def _inv_clvp_plain_encoder(sd, p: str) -> dict:
    tree = {}
    for i in _indices(sd, p + ".layers.layers."):
        lp = f"{p}.layers.layers.{i}"
        tree[f"PlainEncoderLayer_{i}"] = {
            "LayerNorm_0": _inv_norm(sd, lp + ".0.fn.norm"),
            "Dense_0": {"kernel": _np(sd[lp + ".0.fn.fn.to_qkv.weight"]).T},
            "Dense_1": _inv_dense(sd, lp + ".0.fn.fn.to_out.0"),
            "attn_gamma": _np(sd[lp + ".0.scale"]),
            "LayerNorm_1": _inv_norm(sd, lp + ".1.fn.norm"),
            "Dense_2": _inv_dense(sd, lp + ".1.fn.fn.net.0"),
            "Dense_3": _inv_dense(sd, lp + ".1.fn.fn.net.3"),
            "ff_gamma": _np(sd[lp + ".1.scale"])}
    return tree


def clvp_variables(sd) -> dict:
    """ttts_tpu_torch CLVP state dict, either flavour → JAX CLVP variables;
    the inverse of clvp_state_dict."""
    p = {"Embed_0": {"embedding": _np(sd["text_emb.weight"])},
         "Embed_1": {"embedding": _np(sd["speech_emb.weight"])},
         "Dense_0": {"kernel": _np(sd["to_text_latent.weight"]).T},
         "Dense_1": {"kernel": _np(sd["to_speech_latent.weight"]).T},
         "temperature": _np(sd["temperature"]).reshape(())}
    if "text_pos_emb.weight" in sd:
        p["text_pos_emb"] = _np(sd["text_pos_emb.weight"])
        p["speech_pos_emb"] = _np(sd["speech_pos_emb.weight"])
        p["PlainEncoder_0"] = _inv_clvp_plain_encoder(sd, "text_transformer")
        p["PlainEncoder_1"] = _inv_clvp_plain_encoder(sd, "speech_transformer")
    else:
        p["CLVPEncoder_0"] = _inv_clvp_encoder(sd, "text_transformer")
        p["CLVPEncoder_1"] = _inv_clvp_encoder(sd, "speech_transformer")
    return {"params": p}


def classifier_variables(sd) -> dict:
    """ttts_tpu_torch AudioMiniEncoderWithClassifierHead state dict → JAX
    variables; the inverse of classifier_state_dict (enc.res holds each
    depth's resnet blocks, then its strided conv `op`)."""
    enc = {"Conv_0": _inv_conv_flax(sd, "enc.init.0"),
           "GroupNorm32_0": {"GroupNorm_0": _inv_norm(sd, "enc.final.0")},
           "Dense_0": _inv_dense_as_conv1x1(sd, "enc.final.2")}
    blocks = downs = 0
    for j in _indices(sd, "enc.res."):
        bp = f"enc.res.{j}"
        if bp + ".op.weight" in sd:
            downs += 1
            enc[f"Conv_{downs}"] = _inv_conv_flax(sd, bp + ".op")
            continue
        enc[f"ClassifierResBlock_{blocks}"] = {
            "GroupNorm32_0": {"GroupNorm_0": _inv_norm(sd, bp + ".in_layers.0")},
            "Conv_0": _inv_conv_flax(sd, bp + ".in_layers.2"),
            "GroupNorm32_1": {"GroupNorm_0": _inv_norm(sd, bp + ".out_layers.0")},
            "Conv_1": _inv_conv_flax(sd, bp + ".out_layers.3")}
        blocks += 1
    for i in _indices(sd, "enc.attn."):
        enc[f"AttentionBlock_{i}"] = _inv_attn_block(sd, f"enc.attn.{i}")
    return {"params": {"AudioMiniEncoder_0": enc, "Dense_0": _inv_dense(sd, "head")}}


VARIABLES_FNS = {"gpt": unified_voice_variables, "diffusion": aa_diffusion_variables,
                 "vqvae": synthesizer_trn_variables, "discriminator": discriminator_variables,
                 "clvp": clvp_variables, "classifier": classifier_variables,
                 "rvq1": rvq1_variables, "dvae": dvae_variables,
                 "group_quantizer": group_quantizer_variables,
                 "mel_style_encoder_vae": mel_style_encoder_vae_variables,
                 "transformer_decoder": transformer_decoder_variables, "flow": flow_variables,
                 "depthwise_separable_conv": depthwise_separable_conv_variables,
                 "fft": fft_variables, "transformer_coupling": transformer_coupling_variables}
