"""JAX parameter pytrees -> the port's state dicts.

The inverse direction of ``vap_tpu/models/cogvideox/weights.py``,
``vae_weights.py`` and ``text_encoders/t5.py:172``: each function takes the
JAX package's parameter tree with numpy (or array-like) leaves and returns a
``{diffusers key: torch.Tensor}`` dict for ``load_state_dict``. Linear
kernels go from [in, out] to [out, in], conv kernels from channel-last to
torch's [out, in, *kernel], the per-segment block stacks are unstacked, and
LayerNorm ``scale`` becomes ``weight``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .models.cogvideox.config import CogVideoXMOTConfig
from .models.cogvideox.vae import CogVideoXVAEConfig
from .models.text_encoders.t5 import T5Config

StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))  # a writable copy


def _linear(sd: StateDict, prefix: str, p) -> None:
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
    ``CogVideoXTransformer3DMOTModel`` state dict."""
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
    """``init_t5_encoder`` / ``convert_t5_state_dict`` tree (T5 v1.1 with a
    shared relative bias) -> ``T5EncoderModel`` state dict."""
    sd: StateDict = {
        "shared.weight": _t(params["embed"]),
        "encoder.final_layer_norm.weight": _t(params["final_ln"]),
        "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight": _t(params["rel_bias"]),
    }
    for li in range(cfg.num_layers):
        b = _index(params["blocks"], li)
        pre = f"encoder.block.{li}.layer"
        sd[f"{pre}.0.layer_norm.weight"] = _t(b["ln_attn"])
        for name in ("q", "k", "v", "o"):
            _linear(sd, f"{pre}.0.SelfAttention.{name}", b[name])
        sd[f"{pre}.1.layer_norm.weight"] = _t(b["ln_ff"])
        for name in ("wi_0", "wi_1", "wo"):
            _linear(sd, f"{pre}.1.DenseReluDense.{name}", b[name])
    return sd
