"""JAX parameter pytrees -> the port's state dicts.

The inverse direction of ``vap_tpu/models/cogvideox/weights.py``,
``cogvideox/vae_weights.py``, ``wan/weights.py``, ``wan/vae_weights.py``,
``text_encoders/t5.py:172`` and ``text_encoders/clip_vision.py:119``: each
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
from .models.text_encoders.clip_vision import CLIPVisionConfig
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
    kernel = np.asarray(p["proj"]["kernel"])  # [C*p*p, D], (C, ph, pw)-ordered rows
    ps = cfg.patch_size
    sd[f"{prefix}.proj.weight"] = _t(kernel.T.reshape(cfg.inner_dim, cfg.in_channels, ps, ps))
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
    _norm(sd, "norm_final", params["norm_final"])
    _linear(sd, "norm_out.linear", params["norm_out"]["linear"])
    _norm(sd, "norm_out.norm", params["norm_out"]["norm"])
    _linear(sd, "proj_out", params["proj_out"])
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
    _linear(sd, "proj_out", params["proj_out"])
    sd["scale_shift_table"] = _t(np.asarray(params["scale_shift_table"])[None])
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
# LoRA adapters
# ---------------------------------------------------------------------------

def from_jax_lora(lora: Any, cfg) -> Dict[str, Dict[str, torch.Tensor]]:
    """``init_lora`` tree of ``vap_tpu/training/lora.py`` (the params' structure, with
    {"A": [..., in, r], "B": [..., r, out]} in place of each adapted linear's
    ``kernel`` and None elsewhere) -> the port's adapter tree {module name: {"A", "B"}}, the
    per-segment block stacks unstacked (``blocks.<i>`` for Wan,
    ``transformer_blocks.<i>`` for CogVideoX)."""
    blocks = "blocks" if isinstance(cfg, WanMOTConfig) else "transformer_blocks"
    out: Dict[str, Dict[str, torch.Tensor]] = {}

    def module(names) -> str:
        return ".".join(MODULE_SUFFIX.get(str(n), str(n)) for n in names)

    def walk(tree, names) -> None:
        if tree is None:
            return
        if isinstance(tree, dict) and set(tree) == {"A", "B"}:
            a, b = np.asarray(tree["A"]), np.asarray(tree["B"])
            names = names[:-1]  # the adapter sits where the linear's "kernel" does
            if names[0] != "blocks":
                out[module(names)] = {"A": _t(a), "B": _t(b)}
                return
            start, length, _ = cfg.mot_segments[names[1]]
            for i in range(length):
                out[f"{blocks}.{start + i}.{module(names[2:])}"] = {"A": _t(a[i]), "B": _t(b[i])}
            return
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for key, sub in items:
            walk(sub, names + [key])

    walk(lora, [])
    return out
