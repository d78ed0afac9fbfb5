"""Weight carry-over from the JAX package: ttts_tpu params → this package's
state dicts (numpy arrays under the reference's torch key names).

Each function is the inverse of its counterpart in ttts_tpu/models/porting.py
(or models/vocos.py for Vocos), which map a reference torch state dict onto
flax params: feeding the state dict produced here back through that function
returns the JAX params. Inputs are the JAX package's variable trees (nested
dicts of arrays; jax arrays convert through np.asarray, so no JAX import is
needed here).

Layouts: flax Conv kernels (k, in, out) → torch (out, in, k); flax Dense
(in, out) → torch Linear (out, in); GPT-2 Conv1D weights stay (in, out);
flax WeightNorm (kernel v, scale g) → (weight_v, weight_g).

The maps only relayout, so they carry gradients as they carry weights.
`unified_voice_variables` and `aa_diffusion_variables` go the other way,
from this package's state dicts (numpy arrays or tensors) to the JAX
variable trees (VARIABLES_FNS; train/checkpoints.export_release writes
them in the JAX package's release format).
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
    """blocks.ConvTranspose1d {kernel (k, in, out), g (out,), bias} → the
    reference's weight-normed ConvTranspose1d (weight_v (in, out, k),
    weight_g (in, 1, 1)). The JAX module normalises per output channel and
    the reference per input channel, so the effective kernel
    kernel * g / ||kernel|| is stored as v with g its per-input norm: the
    port's g * v / ||v|| is then the JAX module's weight (the inverse of
    ttts_tpu porting._convT, which fuses the other way)."""
    kernel = _a(tree["kernel"])
    norm = np.sqrt((kernel.reshape(-1, kernel.shape[-1]) ** 2).sum(0))
    w = (kernel * (_a(tree["g"]) / np.maximum(norm, 1e-12))).transpose(1, 2, 0)
    sd[p + ".weight_v"] = w
    sd[p + ".weight_g"] = np.sqrt((w ** 2).sum(axis=(1, 2), keepdims=True))
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


def synthesizer_trn_state_dict(variables) -> StateDict:
    """JAX SynthesizerTrn variables {'params', 'codebook'} → the state dict
    of ttts_tpu_torch.models.vqvae.SynthesizerTrn (ref_enc, enc_p, enc_p_2,
    flow, dec, proj, quantizer; enc_q, which serving does not build and
    release exports drop, is skipped). Inverse of port_synthesizer_trn_state
    (for dec's transposed convolutions, in their effective weights)."""
    params = variables["params"]
    sd: StateDict = {}
    _mel_style_encoder(sd, "ref_enc", params["ref_enc"])
    _posterior_audio_encoder(sd, "enc_p", params["enc_p"])
    _text_encoder(sd, "enc_p_2", params["enc_p_2"])
    _coupling_flow(sd, "flow", params["flow"])
    _generator(sd, "dec", params["dec"])
    _conv(sd, "proj", params["proj"])
    state = variables["codebook"]["quantizer"]["state"]
    get = (lambda k: state[k]) if isinstance(state, dict) else (lambda k: getattr(state, k))
    embed, embed_avg, size = _a(get("embed")), _a(get("embed_avg")), _a(get("cluster_size"))
    inited = np.asarray(get("inited"), np.float32).reshape(1)
    for i in range(embed.shape[0]):
        cb = f"quantizer.vq.layers.{i}._codebook"
        sd[cb + ".embed"] = embed[i]
        sd[cb + ".embed_avg"] = embed_avg[i]
        sd[cb + ".cluster_size"] = size[i]
        sd[cb + ".inited"] = inited
    return sd


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


STATE_DICT_FNS = {
    "codec": synthesizer_trn_state_dict,
    "gpt": unified_voice_state_dict,
    "diffusion": aa_diffusion_state_dict,
    "vocos": vocos_state_dict,
    "clvp": clvp_state_dict,
    "classifier": classifier_state_dict,
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
    pool = {"latents": _np(sd["refer_enc.4.latents"]),
            "Conv_0": _inv_conv_flax(sd, "refer_enc.4.enc.0")}
    for i, name in enumerate(("conv_q", "conv_k", "conv_v", "conv_o")):
        pool[f"Dense_{i}"] = _inv_dense_as_conv1x1(sd, f"refer_enc.4.cross_attention.{name}")
    for i in range(len(_indices(sd, "refer_enc.4.enc.")) - 1):
        pool[f"AttentionBlock_{i}"] = _inv_attn_block(sd, f"refer_enc.4.enc.{i + 1}")
    p["refer_pool"] = pool
    return {"params": p}


VARIABLES_FNS = {"gpt": unified_voice_variables, "diffusion": aa_diffusion_variables}
