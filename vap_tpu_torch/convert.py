"""JAX parameter pytrees -> the port's state dicts.

The inverse direction of ``vap_tpu/models/cogvideox/weights.py``,
``cogvideox/vae_weights.py``, ``wan/weights.py``, ``wan/vae_weights.py``,
``hunyuan_video/transformer.py:409`` and ``hunyuan_video/vae.py:294``,
``text_encoders/t5.py:172``, ``text_encoders/clip_vision.py:119``,
``text_encoders/llama.py:149`` and ``text_encoders/clip_text.py:112``: each
function takes the JAX package's parameter tree with numpy (or array-like)
leaves and returns a ``{diffusers/HF key: torch.Tensor}`` dict for
``load_state_dict``. Linear kernels go from [in, out] to [out, in], conv
kernels from channel-last to torch's [out, in, *kernel], the per-segment
block stacks are unstacked, and LayerNorm ``scale`` becomes ``weight``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .models.cogvideox.config import CogVideoXMOTConfig
from .models.cogvideox.vae import CogVideoXVAEConfig
from .models.hunyuan_video.config import HunyuanVideoConfig
from .models.hunyuan_video.vae import HunyuanVideoVAEConfig
from .models.text_encoders.clip_text import CLIPTextConfig
from .models.text_encoders.clip_vision import CLIPVisionConfig
from .models.text_encoders.llama import LlamaConfig
from .models.text_encoders.t5 import T5Config
from .models.wan.config import WanMOTConfig
from .models.wan.vae import WanVAEConfig
from .training.lora import MODULE_SUFFIX

StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))  # a writable copy


def _linear(sd: StateDict, prefix: str, p) -> None:
    """A linear: {"kernel" [in, out], "bias"?}, or the W8A8 leaf of
    ``quantize_transformer_linears`` {"w_i8" [in, out], "s_w", "bias"?},
    which goes into an ``Int8Linear``'s buffers (w_i8 as [out, in])."""
    if "w_i8" in p:
        sd[f"{prefix}.w_i8"] = _t(np.asarray(p["w_i8"]).T)
        sd[f"{prefix}.s_w"] = _t(p["s_w"])
    else:
        sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _norm(sd: StateDict, prefix: str, p) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


# ---------------------------------------------------------------------------
# transformer
# ---------------------------------------------------------------------------

def _patch_embed(sd: StateDict, prefix: str, p, cfg: CogVideoXMOTConfig) -> None:
    # [C*p*p, D], (C, ph, pw)-ordered rows: a Conv2d kernel; with
    # patch_size_t [C*pt*p*p, D], a Linear's weight transposed
    kernel = np.asarray(p["proj"]["kernel"])
    ps = cfg.patch_size
    sd[f"{prefix}.proj.weight"] = _t(kernel.T if cfg.patch_size_t else
                                     kernel.T.reshape(cfg.inner_dim, cfg.in_channels, ps, ps))
    sd[f"{prefix}.proj.bias"] = _t(p["proj"]["bias"])
    _linear(sd, f"{prefix}.text_proj", p["text_proj"])
    if "pos_embedding" in p:
        sd[f"{prefix}.pos_embedding"] = _t(np.asarray(p["pos_embedding"])[None])


def _norm_zero(sd, prefix, p):
    _linear(sd, f"{prefix}.linear", p["linear"])
    _norm(sd, f"{prefix}.norm", p["norm"])


def _attention(sd, prefix, p):
    for name in ("to_q", "to_k", "to_v"):
        _linear(sd, f"{prefix}.{name}", p[name])
    _linear(sd, f"{prefix}.to_out.0", p["to_out"])
    _norm(sd, f"{prefix}.norm_q", p["norm_q"])
    _norm(sd, f"{prefix}.norm_k", p["norm_k"])


def _block(sd, prefix, p, has_mot: bool):
    suffixes = ("", "_mot_ref") if has_mot else ("",)
    for s in suffixes:
        _norm_zero(sd, f"{prefix}.norm1{s}", p[f"norm1{s}"])
        _attention(sd, f"{prefix}.attn1{s}", p[f"attn1{s}"])
        _norm_zero(sd, f"{prefix}.norm2{s}", p[f"norm2{s}"])
        _linear(sd, f"{prefix}.ff{s}.net.0.proj", p[f"ff{s}"]["net_0"])
        _linear(sd, f"{prefix}.ff{s}.net.2", p[f"ff{s}"]["net_2"])


def _index(tree, i: int):
    """Slice layer i out of a stacked block tree."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def from_jax_transformer(params: Dict[str, Any], cfg: CogVideoXMOTConfig) -> StateDict:
    """``init_cogvideox_mot`` / ``convert_cogvideox_mot_state_dict`` tree ->
    ``CogVideoXTransformer3DMOTModel`` state dict. A tree quantised by the
    JAX package's ``quantize_transformer_linears`` gives ``w_i8``/``s_w``
    keys for its projections: load it into a model quantised with the
    port's ``quantize_transformer_linears``."""
    sd: StateDict = {}
    _patch_embed(sd, "patch_embed", params["patch_embed"], cfg)
    _patch_embed(sd, "patch_embed_mot_ref", params["patch_embed_mot_ref"], cfg)
    for name in ("time_embedding", "time_embedding_mot_ref"):
        _linear(sd, f"{name}.linear_1", params[name]["linear_1"])
        _linear(sd, f"{name}.linear_2", params[name]["linear_2"])
    if "ofs_embedding" in params:
        _linear(sd, "ofs_embedding.linear_1", params["ofs_embedding"]["linear_1"])
        _linear(sd, "ofs_embedding.linear_2", params["ofs_embedding"]["linear_2"])
    for s in ("", "_mot_ref") if "proj_out_mot_ref" in params else ("",):
        _norm(sd, f"norm_final{s}", params[f"norm_final{s}"])
        _linear(sd, f"norm_out{s}.linear", params[f"norm_out{s}"]["linear"])
        _norm(sd, f"norm_out{s}.norm", params[f"norm_out{s}"]["norm"])
        _linear(sd, f"proj_out{s}", params[f"proj_out{s}"])
    for name, keys in (("effect_embeddings", cfg.supported_effect_types),
                       ("ref_embeddings", [f"ref_{i}" for i in range(cfg.num_ref_embeddings or 0)])):
        if name in params:  # [N, D] -> one [1, 1, D] entry per name
            for key, row in zip(keys, np.asarray(params[name])):
                sd[f"{name}.{key}"] = _t(row.reshape(1, 1, -1))
    for (start, length, has_mot), seg in zip(cfg.mot_segments, params["blocks"]):
        for i in range(length):
            _block(sd, f"transformer_blocks.{start + i}", _index(seg, i), has_mot)
    return sd


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------

_CAUSAL_CONVS = ("conv_in", "conv_out", "conv1", "conv2", "conv_y", "conv_b")


def _vae_key(name: str) -> str:
    for jax_name, torch_name in (("down_block_", "down_blocks."), ("up_block_", "up_blocks."),
                                 ("resnet_", "resnets.")):
        if name.startswith(jax_name):
            return torch_name + name[len(jax_name):]
    return {"downsampler": "downsamplers.0", "upsampler": "upsamplers.0"}.get(name, name)


def _vae_tree(sd: StateDict, prefix: str, name: str, p) -> None:
    if "kernel" in p:
        k = np.asarray(p["kernel"])
        # channel-last [k..., I, O] -> [O, I, k...]
        w = k.transpose(k.ndim - 1, k.ndim - 2, *range(k.ndim - 2))
        key = f"{prefix}.conv" if name in _CAUSAL_CONVS else prefix
        sd[f"{key}.weight"] = _t(w)
        sd[f"{key}.bias"] = _t(p["bias"])
    elif "scale" in p:
        _norm(sd, prefix, p)
    else:
        for child, sub in p.items():
            _vae_tree(sd, f"{prefix}.{_vae_key(child)}", child, sub)


def from_jax_vae(params: Dict[str, Any], cfg: CogVideoXVAEConfig) -> StateDict:
    """``init_cogvideox_vae`` / ``convert_cogvideox_vae_state_dict`` tree ->
    ``AutoencoderKLCogVideoX`` state dict."""
    del cfg  # the tree carries every shape
    sd: StateDict = {}
    for part in ("encoder", "decoder"):
        _vae_tree(sd, part, part, params[part])
    return sd


# ---------------------------------------------------------------------------
# T5
# ---------------------------------------------------------------------------

def from_jax_t5(params: Dict[str, Any], cfg: T5Config) -> StateDict:
    """``init_t5_encoder`` / ``convert_t5_state_dict`` tree -> ``T5EncoderModel``
    state dict: T5 v1.1 (one relative bias table, in block 0) or UMT5
    (``per_layer_relative_bias``: a table in every block)."""
    sd: StateDict = {
        "shared.weight": _t(params["embed"]),
        "encoder.final_layer_norm.weight": _t(params["final_ln"]),
    }
    bias_key = "encoder.block.{}.layer.0.SelfAttention.relative_attention_bias.weight"
    if not cfg.per_layer_relative_bias:
        sd[bias_key.format(0)] = _t(params["rel_bias"])
    for li in range(cfg.num_layers):
        b = _index(params["blocks"], li)
        pre = f"encoder.block.{li}.layer"
        sd[f"{pre}.0.layer_norm.weight"] = _t(b["ln_attn"])
        for name in ("q", "k", "v", "o"):
            _linear(sd, f"{pre}.0.SelfAttention.{name}", b[name])
        sd[f"{pre}.1.layer_norm.weight"] = _t(b["ln_ff"])
        for name in ("wi_0", "wi_1", "wo"):
            _linear(sd, f"{pre}.1.DenseReluDense.{name}", b[name])
        if cfg.per_layer_relative_bias:
            sd[bias_key.format(li)] = _t(b["rel_bias"])
    return sd


# ---------------------------------------------------------------------------
# CLIP vision
# ---------------------------------------------------------------------------

def from_jax_clip_vision(params: Dict[str, Any], cfg: CLIPVisionConfig) -> StateDict:
    """``init_clip_vision`` / ``convert_clip_vision_state_dict`` tree ->
    ``CLIPVisionModel`` state dict (HF keys)."""
    pre = "vision_model"
    kernel = np.asarray(params["patch_embed"]["kernel"])  # HWIO
    sd: StateDict = {
        f"{pre}.embeddings.patch_embedding.weight": _t(kernel.transpose(3, 2, 0, 1)),
        f"{pre}.embeddings.class_embedding": _t(params["class_embed"]),
        f"{pre}.embeddings.position_embedding.weight": _t(params["pos_embed"]),
    }
    _norm(sd, f"{pre}.pre_layrnorm", params["pre_ln"])
    _norm(sd, f"{pre}.post_layernorm", params["post_ln"])
    for li in range(cfg.num_hidden_layers):
        b = _index(params["blocks"], li)
        bp = f"{pre}.encoder.layers.{li}"
        _norm(sd, f"{bp}.layer_norm1", b["ln1"])
        _norm(sd, f"{bp}.layer_norm2", b["ln2"])
        for jax_name, name in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "out_proj")):
            _linear(sd, f"{bp}.self_attn.{name}", b[jax_name])
        _linear(sd, f"{bp}.mlp.fc1", b["fc1"])
        _linear(sd, f"{bp}.mlp.fc2", b["fc2"])
    return sd


# ---------------------------------------------------------------------------
# Wan transformer
# ---------------------------------------------------------------------------

def _wan_attention(sd, prefix, p):
    for name in ("to_q", "to_k", "to_v", "add_k_proj", "add_v_proj"):
        if name in p:
            _linear(sd, f"{prefix}.{name}", p[name])
    _linear(sd, f"{prefix}.to_out.0", p["to_out"])
    for name in ("norm_q", "norm_k", "norm_added_k"):
        if name in p:
            sd[f"{prefix}.{name}.weight"] = _t(p[name]["scale"])


def _wan_block(sd, prefix, p, has_mot: bool):
    for s in ("", "_mot_ref") if has_mot else ("",):
        _wan_attention(sd, f"{prefix}.attn1{s}", p[f"attn1{s}"])
        _wan_attention(sd, f"{prefix}.attn2{s}", p[f"attn2{s}"])
        if p[f"norm2{s}"]:
            _norm(sd, f"{prefix}.norm2{s}", p[f"norm2{s}"])
        _linear(sd, f"{prefix}.ffn{s}.net.0.proj", p[f"ffn{s}"]["net_0"])
        _linear(sd, f"{prefix}.ffn{s}.net.2", p[f"ffn{s}"]["net_2"])
        sd[f"{prefix}.scale_shift_table{s}"] = _t(np.asarray(p[f"scale_shift_table{s}"])[None])


def _wan_condition_embedder(sd, prefix, p):
    for name in ("time_embedder", "text_embedder"):
        _linear(sd, f"{prefix}.{name}.linear_1", p[name]["linear_1"])
        _linear(sd, f"{prefix}.{name}.linear_2", p[name]["linear_2"])
    _linear(sd, f"{prefix}.time_proj", p["time_proj"])
    if "image_embedder" in p:
        ie, pre = p["image_embedder"], f"{prefix}.image_embedder"
        _norm(sd, f"{pre}.norm1", ie["norm1"])
        _linear(sd, f"{pre}.ff.net.0.proj", ie["ff"]["net_0"])
        _linear(sd, f"{pre}.ff.net.2", ie["ff"]["net_2"])
        _norm(sd, f"{pre}.norm2", ie["norm2"])
        if "pos_embed" in ie:
            sd[f"{pre}.pos_embed"] = _t(ie["pos_embed"])


def from_jax_wan_transformer(params: Dict[str, Any], cfg: WanMOTConfig) -> StateDict:
    """``init_wan_mot`` / ``convert_wan_mot_state_dict`` tree, or the plain
    ``init_wan`` tree (no ``_mot_ref`` entry, one block segment) ->
    ``WanTransformer3DMOTModel`` state dict: the per-segment block stacks
    are unstacked, the patch linear becomes a Conv3d kernel."""
    sd: StateDict = {}
    shape = (cfg.inner_dim, cfg.in_channels, *cfg.patch_size)
    for name in ("patch_embedding", "patch_embedding_mot_ref"):
        if name not in params:
            continue
        kernel = np.asarray(params[name]["kernel"])  # [(C, pt, ph, pw), D]
        sd[f"{name}.weight"] = _t(kernel.T.reshape(shape))
        sd[f"{name}.bias"] = _t(params[name]["bias"])
    for name in ("condition_embedder", "condition_embedder_mot_ref"):
        if name in params:
            _wan_condition_embedder(sd, name, params[name])
    for s in ("", "_mot_ref") if "proj_out_mot_ref" in params else ("",):
        _linear(sd, f"proj_out{s}", params[f"proj_out{s}"])
        sd[f"scale_shift_table{s}"] = _t(np.asarray(params[f"scale_shift_table{s}"])[None])
    for (start, length, has_mot), seg in zip(cfg.mot_segments, params["blocks"]):
        for i in range(length):
            _wan_block(sd, f"blocks.{start + i}", _index(seg, i), has_mot)
    return sd


# ---------------------------------------------------------------------------
# Wan VAE
# ---------------------------------------------------------------------------

def _wan_vae_key(name: str) -> str:
    for jax_name, torch_name in (("layer_", "down_blocks."), ("up_block_", "up_blocks."),
                                 ("resnet_", "resnets."), ("attn_", "attentions.")):
        if name.startswith(jax_name):
            return torch_name + name[len(jax_name):]
    return {"upsampler": "upsamplers.0", "conv": "resample.1"}.get(name, name)


def _wan_vae_tree(sd: StateDict, prefix: str, p, in_attention: bool = False) -> None:
    if "kernel" in p:
        k = np.asarray(p["kernel"])
        if k.ndim == 2:  # the attention's 1x1 convs, a linear [in, out] in JAX
            w = k.T[:, :, None, None]
        else:  # channel-last [k..., I, O] -> [O, I, k...]
            w = k.transpose(k.ndim - 1, k.ndim - 2, *range(k.ndim - 2))
        sd[f"{prefix}.weight"] = _t(w)
        sd[f"{prefix}.bias"] = _t(p["bias"])
    elif "gamma" in p:
        g = np.asarray(p["gamma"]).reshape(-1, *((1, 1) if in_attention else (1, 1, 1)))
        sd[f"{prefix}.gamma"] = _t(g)
    else:
        for child, sub in p.items():
            _wan_vae_tree(sd, f"{prefix}.{_wan_vae_key(child)}", sub,
                          in_attention or child.startswith("attn_"))


def from_jax_wan_vae(params: Dict[str, Any], cfg: WanVAEConfig) -> StateDict:
    """``init_wan_vae`` / ``convert_wan_vae_state_dict`` tree ->
    ``AutoencoderKLWan`` state dict (diffusers keys)."""
    del cfg  # the tree carries every shape
    sd: StateDict = {}
    for part in ("encoder", "decoder", "quant_conv", "post_quant_conv"):
        _wan_vae_tree(sd, part, params[part])
    return sd


# ---------------------------------------------------------------------------
# HunyuanVideo transformer and VAE decoder
# ---------------------------------------------------------------------------

def _mlp(sd, prefix, p):
    _linear(sd, f"{prefix}.linear_1", p["linear_1"])
    _linear(sd, f"{prefix}.linear_2", p["linear_2"])


def _hunyuan_attention(sd, prefix, p):
    for name in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj", "to_add_out"):
        if name in p:
            _linear(sd, f"{prefix}.{name}", p[name])
    if "to_out" in p:
        _linear(sd, f"{prefix}.to_out.0", p["to_out"])
    for name in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
        if name in p:
            sd[f"{prefix}.{name}.weight"] = _t(p[name]["scale"])


def _ff(sd, prefix, p):
    _linear(sd, f"{prefix}.net.0.proj", p["net_0"])
    _linear(sd, f"{prefix}.net.2", p["net_2"])


def from_jax_hunyuan_transformer(params: Dict[str, Any], cfg: HunyuanVideoConfig) -> StateDict:
    """``init_hunyuan_video`` / ``convert_hunyuan_video_state_dict`` tree ->
    ``HunyuanVideoTransformer3DModel`` state dict: the dual, single and
    refiner block stacks unstacked, the patch linear as a Conv3d kernel."""
    sd: StateDict = {}
    kernel = np.asarray(params["x_embedder"]["kernel"])  # [(C, pt, p, p), D]
    sd["x_embedder.proj.weight"] = _t(kernel.T.reshape(
        cfg.inner_dim, cfg.in_channels, cfg.patch_size_t, cfg.patch_size, cfg.patch_size))
    sd["x_embedder.proj.bias"] = _t(params["x_embedder"]["bias"])
    ce = params["context_embedder"]
    for name, sub in ce["time_text_embed"].items():
        _mlp(sd, f"context_embedder.time_text_embed.{name}", sub)
    _linear(sd, "context_embedder.proj_in", ce["proj_in"])
    for i in range(cfg.num_refiner_layers):
        b, pre = _index(ce["refiner_blocks"], i), f"context_embedder.token_refiner.refiner_blocks.{i}"
        _norm(sd, f"{pre}.norm1", b["norm1"])
        _norm(sd, f"{pre}.norm2", b["norm2"])
        _hunyuan_attention(sd, f"{pre}.attn", b["attn"])
        _ff(sd, f"{pre}.ff", b["ff"])
        _linear(sd, f"{pre}.norm_out.linear", b["norm_out"]["linear"])
    for name, sub in params["time_text_embed"].items():
        _mlp(sd, f"time_text_embed.{name}", sub)
    for i in range(cfg.num_layers):
        b, pre = _index(params["dual_blocks"], i), f"transformer_blocks.{i}"
        _linear(sd, f"{pre}.norm1.linear", b["norm1"]["linear"])
        _linear(sd, f"{pre}.norm1_context.linear", b["norm1_context"]["linear"])
        _hunyuan_attention(sd, f"{pre}.attn", b["attn"])
        _ff(sd, f"{pre}.ff", b["ff"])
        _ff(sd, f"{pre}.ff_context", b["ff_context"])
    for i in range(cfg.num_single_layers):
        b, pre = _index(params["single_blocks"], i), f"single_transformer_blocks.{i}"
        _linear(sd, f"{pre}.norm.linear", b["norm"]["linear"])
        _linear(sd, f"{pre}.proj_mlp", b["proj_mlp"])
        _linear(sd, f"{pre}.proj_out", b["proj_out"])
        _hunyuan_attention(sd, f"{pre}.attn", b["attn"])
    _linear(sd, "norm_out.linear", params["norm_out"]["linear"])
    _linear(sd, "proj_out", params["proj_out"])
    return sd


def _conv3d(sd, prefix, p):
    """A channel-last [kt, kh, kw, I, O] conv kernel -> [O, I, kt, kh, kw]."""
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).transpose(4, 3, 0, 1, 2))
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _hunyuan_resnet(sd, prefix, p):
    _norm(sd, f"{prefix}.norm1", p["norm1"])
    _norm(sd, f"{prefix}.norm2", p["norm2"])
    for name in ("conv1", "conv2", "conv_shortcut"):
        if name in p:
            _conv3d(sd, f"{prefix}.{name}.conv", p[name])


def _hunyuan_mid(sd, prefix, mid, cfg: HunyuanVideoVAEConfig):
    for j, r in enumerate(mid["resnets"]):
        _hunyuan_resnet(sd, f"{prefix}.resnets.{j}", r)
    if cfg.mid_block_add_attention:
        a, pre = mid["attention"], f"{prefix}.attentions.0"
        _norm(sd, f"{pre}.group_norm", a["group_norm"])
        for name in ("to_q", "to_k", "to_v"):
            _linear(sd, f"{pre}.{name}", a[name])
        _linear(sd, f"{pre}.to_out.0", a["to_out"])


def from_jax_hunyuan_vae(params: Dict[str, Any], cfg: HunyuanVideoVAEConfig) -> StateDict:
    """``init_hunyuan_vae`` / ``convert_hunyuan_vae_state_dict`` tree -> the
    port's ``AutoencoderKLHunyuanVideo`` state dict: the encoder and
    ``quant_conv``, the decoder and ``post_quant_conv``."""
    sd: StateDict = {}
    e = params["encoder"]
    _conv3d(sd, "encoder.conv_in.conv", e["conv_in"])
    for i, blk in enumerate(e["down_blocks"]):
        for j, r in enumerate(blk["resnets"]):
            _hunyuan_resnet(sd, f"encoder.down_blocks.{i}.resnets.{j}", r)
        if "downsample" in blk:
            _conv3d(sd, f"encoder.down_blocks.{i}.downsamplers.0.conv.conv",
                    blk["downsample"]["conv"])
    _hunyuan_mid(sd, "encoder.mid_block", e["mid_block"], cfg)
    _norm(sd, "encoder.conv_norm_out", e["conv_norm_out"])
    _conv3d(sd, "encoder.conv_out.conv", e["conv_out"])
    _conv3d(sd, "quant_conv", params["quant_conv"])
    d = params["decoder"]
    _conv3d(sd, "decoder.conv_in.conv", d["conv_in"])
    _hunyuan_mid(sd, "decoder.mid_block", d["mid_block"], cfg)
    for i, blk in enumerate(d["up_blocks"]):
        for j, r in enumerate(blk["resnets"]):
            _hunyuan_resnet(sd, f"decoder.up_blocks.{i}.resnets.{j}", r)
        if "upsample" in blk:
            _conv3d(sd, f"decoder.up_blocks.{i}.upsamplers.0.conv.conv", blk["upsample"]["conv"])
    _norm(sd, "decoder.conv_norm_out", d["conv_norm_out"])
    _conv3d(sd, "decoder.conv_out.conv", d["conv_out"])
    _conv3d(sd, "post_quant_conv", params["post_quant_conv"])
    return sd


# ---------------------------------------------------------------------------
# LLaMA and CLIP text
# ---------------------------------------------------------------------------

def from_jax_llama(params: Dict[str, Any], cfg: LlamaConfig) -> StateDict:
    """``init_llama`` / ``convert_llama_state_dict`` tree -> ``LlamaModel``
    state dict (HF keys without the ``model.`` prefix)."""
    sd: StateDict = {"embed_tokens.weight": _t(params["embed_tokens"]),
                     "norm.weight": _t(params["norm"]["scale"])}
    for i in range(cfg.num_hidden_layers):
        b, pre = _index(params["blocks"], i), f"layers.{i}"
        sd[f"{pre}.input_layernorm.weight"] = _t(b["input_layernorm"]["scale"])
        sd[f"{pre}.post_attention_layernorm.weight"] = _t(b["post_attention_layernorm"]["scale"])
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            _linear(sd, f"{pre}.self_attn.{name}", b[name])
        for name in ("gate_proj", "up_proj", "down_proj"):
            _linear(sd, f"{pre}.mlp.{name}", b[name])
    return sd


def from_jax_clip_text(params: Dict[str, Any], cfg: CLIPTextConfig) -> StateDict:
    """``init_clip_text`` / ``convert_clip_text_state_dict`` tree ->
    ``CLIPTextModel`` state dict (HF keys)."""
    pre = "text_model"
    sd: StateDict = {
        f"{pre}.embeddings.token_embedding.weight": _t(params["token_embedding"]),
        f"{pre}.embeddings.position_embedding.weight": _t(params["position_embedding"]),
    }
    _norm(sd, f"{pre}.final_layer_norm", params["final_layer_norm"])
    for i in range(cfg.num_hidden_layers):
        b, bp = _index(params["blocks"], i), f"{pre}.encoder.layers.{i}"
        _norm(sd, f"{bp}.layer_norm1", b["layer_norm1"])
        _norm(sd, f"{bp}.layer_norm2", b["layer_norm2"])
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(sd, f"{bp}.self_attn.{name}", b[name])
        _linear(sd, f"{bp}.mlp.fc1", b["fc1"])
        _linear(sd, f"{bp}.mlp.fc2", b["fc2"])
    return sd


# ---------------------------------------------------------------------------
# LoRA adapters
# ---------------------------------------------------------------------------

# HunyuanVideo's stacked block trees -> the port's module lists
HUNYUAN_STACKS = {("dual_blocks",): "transformer_blocks",
                  ("single_blocks",): "single_transformer_blocks",
                  ("context_embedder", "refiner_blocks"):
                      "context_embedder.token_refiner.refiner_blocks"}


def from_jax_lora(lora: Any, cfg) -> Dict[str, Dict[str, torch.Tensor]]:
    """``init_lora`` tree of ``vap_tpu/training/lora.py`` (the params' structure, with
    {"A": [..., in, r], "B": [..., r, out]} in place of each adapted linear's
    ``kernel`` and None elsewhere) -> the port's adapter tree {module name: {"A", "B"}}, the
    block stacks unstacked: per segment ``blocks.<i>`` for Wan and
    ``transformer_blocks.<i>`` for CogVideoX; for HunyuanVideo ``dual_blocks`` ->
    ``transformer_blocks.<i>``, ``single_blocks`` -> ``single_transformer_blocks.<i>``
    and ``context_embedder.refiner_blocks`` ->
    ``context_embedder.token_refiner.refiner_blocks.<i>``."""
    blocks = "blocks" if isinstance(cfg, WanMOTConfig) else "transformer_blocks"
    out: Dict[str, Dict[str, torch.Tensor]] = {}

    def module(names) -> str:
        return ".".join(MODULE_SUFFIX.get(str(n), str(n)) for n in names)

    def unstack(a, b, prefix: str, start: int, rest) -> None:
        for i in range(a.shape[0]):
            out[f"{prefix}.{start + i}.{module(rest)}"] = {"A": _t(a[i]), "B": _t(b[i])}

    def walk(tree, names) -> None:
        if tree is None:
            return
        if isinstance(tree, dict) and set(tree) == {"A", "B"}:
            a, b = np.asarray(tree["A"]), np.asarray(tree["B"])
            names = names[:-1]  # the adapter sits where the linear's "kernel" does
            if isinstance(cfg, HunyuanVideoConfig):
                for stack, prefix in HUNYUAN_STACKS.items():
                    if tuple(names[:len(stack)]) == stack:
                        return unstack(a, b, prefix, 0, names[len(stack):])
            elif names[0] == "blocks":
                return unstack(a, b, blocks, cfg.mot_segments[names[1]][0], names[2:])
            out[module(names)] = {"A": _t(a), "B": _t(b)}
            return
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for key, sub in items:
            walk(sub, names + [key])

    walk(lora, [])
    return out
