"""The MoT expert of a VAP transformer, cloned from a stock checkpoint.

Port of ``vap_tpu/training/specs.py:25-165`` (``expected_mot_ref_shapes``,
``_xavier_uniform``, ``build_mot_state_dict_from_base``,
``build_wan_mot_state_dict_from_base``). The state dicts are mappings of
diffusers keys to tensors (a ``SafetensorsDict`` of a stock CogVideoX or
Wan checkpoint, typically): a clone is the same tensor under the
``_mot_ref`` name, no copy. Fresh weights (a base-vs-target shape mismatch
under a custom structure) and the zero effect / reference embeddings are
drawn with numpy's ``default_rng(seed)`` in JAX's order, so they equal
JAX's to the bit.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch

from ..models.cogvideox.config import CogVideoXMOTConfig

StateDict = Dict[str, torch.Tensor]


# --- copied from vap_tpu/training/specs.py:25-74 ----------------------------
def expected_mot_ref_shapes(cfg: CogVideoXMOTConfig) -> Dict[str, tuple]:
    """HF-layout shapes of every `*_mot_ref` parameter a config-built MoT model
    would carry (the target side of the reference's clone loop, cogvideox spec
    base_specification.py:398-422). Used to detect base-vs-target shape
    mismatches when a custom (non-config_ori) structure JSON changes dims."""
    d, t, e = cfg.inner_dim, cfg.time_embed_dim, cfg.text_embed_dim
    p, pt, hd = cfg.patch_size, cfg.patch_size_t, cfg.attention_head_dim
    shapes: Dict[str, tuple] = {
        "patch_embed_mot_ref.proj.weight":
            (d, cfg.in_channels * p * p * pt) if pt else (d, cfg.in_channels, p, p),
        "patch_embed_mot_ref.proj.bias": (d,),
        "patch_embed_mot_ref.text_proj.weight": (d, e),
        "patch_embed_mot_ref.text_proj.bias": (d,),
        "time_embedding_mot_ref.linear_1.weight": (t, d),
        "time_embedding_mot_ref.linear_1.bias": (t,),
        "time_embedding_mot_ref.linear_2.weight": (t, t),
        "time_embedding_mot_ref.linear_2.bias": (t,),
    }
    if cfg.use_learned_positional_embeddings:
        shapes["patch_embed_mot_ref.pos_embedding"] = (1, cfg.joint_pos_embed_length, d)
    for i in cfg.block_idx_with_mot_ref:
        pre = f"transformer_blocks.{i}."
        for nrm in ("norm1_mot_ref", "norm2_mot_ref"):
            shapes[pre + nrm + ".linear.weight"] = (6 * d, t)
            shapes[pre + nrm + ".linear.bias"] = (6 * d,)
            shapes[pre + nrm + ".norm.weight"] = (d,)
            shapes[pre + nrm + ".norm.bias"] = (d,)
        for proj in ("to_q", "to_k", "to_v", "to_out.0"):
            shapes[pre + f"attn1_mot_ref.{proj}.weight"] = (d, d)
            shapes[pre + f"attn1_mot_ref.{proj}.bias"] = (d,)
        for qk in ("norm_q", "norm_k"):
            shapes[pre + f"attn1_mot_ref.{qk}.weight"] = (hd,)
            shapes[pre + f"attn1_mot_ref.{qk}.bias"] = (hd,)
        shapes[pre + "ff_mot_ref.net.0.proj.weight"] = (4 * d, d)
        shapes[pre + "ff_mot_ref.net.0.proj.bias"] = (4 * d,)
        shapes[pre + "ff_mot_ref.net.2.weight"] = (d, 4 * d)
        shapes[pre + "ff_mot_ref.net.2.bias"] = (d,)
    if cfg.reference_train_mode == "reference_independent":
        out_dim = (cfg.out_channels or cfg.in_channels) * p * p * (pt or 1)
        shapes.update({
            "norm_final_mot_ref.weight": (d,),
            "norm_final_mot_ref.bias": (d,),
            "norm_out_mot_ref.linear.weight": (2 * d, t),
            "norm_out_mot_ref.linear.bias": (2 * d,),
            "norm_out_mot_ref.norm.weight": (d,),
            "norm_out_mot_ref.norm.bias": (d,),
            "proj_out_mot_ref.weight": (out_dim, d),
            "proj_out_mot_ref.bias": (out_dim,),
        })
    return shapes


# --- copied from vap_tpu/training/specs.py:77-83 ----------------------------
def _xavier_uniform(rng: np.random.Generator, shape: tuple) -> np.ndarray:
    """torch.nn.init.xavier_uniform_ (gain=1): fan_in/out per torch's
    _calculate_fan_in_and_fan_out (receptive field folded into both fans)."""
    recep = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    fan_out, fan_in = shape[0] * recep, shape[1] * recep
    a = float(np.sqrt(6.0 / (fan_in + fan_out)))
    return rng.uniform(-a, a, size=shape).astype(np.float32)


def build_mot_state_dict_from_base(sd: Mapping, cfg: CogVideoXMOTConfig,
                                   seed: int = 0) -> StateDict:
    """Clone a plain CogVideoX checkpoint's weights into the MoT expert
    branch (``build_mot_state_dict_from_base``): every `X` gains an
    `X_mot_ref` entry, the same tensor, when shapes match; on a mismatch the
    expert's weight is fresh (xavier-uniform; norm weights 1 + 0.02 * noise;
    biases zero), and effect / reference embeddings start at zero. Keys
    already present (a finetuned MoT checkpoint's branch) are kept."""
    out = dict(sd)
    targets = expected_mot_ref_shapes(cfg)
    rng = np.random.default_rng(seed)

    def _fresh(tgt: str, shape: tuple) -> torch.Tensor:
        if len(shape) > 1:
            return torch.from_numpy(_xavier_uniform(rng, shape))
        if tgt.endswith(".weight") and "norm" in tgt:
            return torch.from_numpy(
                (np.ones(shape) + 0.02 * rng.standard_normal(shape)).astype(np.float32))
        if tgt.endswith(".bias"):
            return torch.zeros(shape, dtype=torch.float32)
        raise ValueError(f"no base parameter for {tgt} with shape {shape}")

    def _clone(src_prefix: str, dst_prefix: str):
        for k in list(sd):
            if k.startswith(src_prefix):
                tgt = k.replace(src_prefix, dst_prefix, 1)
                if tgt in out:  # keep a finetuned checkpoint's MoT branch
                    continue
                want = targets.get(tgt)
                if want is not None and tuple(sd[k].shape) != want:
                    out[tgt] = _fresh(tgt, want)
                else:
                    out[tgt] = sd[k]

    for name in ("patch_embed", "time_embedding"):
        _clone(name + ".", name + "_mot_ref.")
    for i in cfg.block_idx_with_mot_ref:
        pre = f"transformer_blocks.{i}."
        for sub in ("norm1", "attn1", "norm2", "ff"):
            _clone(pre + sub + ".", pre + sub + "_mot_ref.")
    if cfg.reference_train_mode == "reference_independent":
        for name in ("norm_final", "norm_out", "proj_out"):
            _clone(name + ".", name + "_mot_ref.")
    dim = cfg.inner_dim
    for t in cfg.supported_effect_types:
        if f"effect_embeddings.{t}" not in out:
            out[f"effect_embeddings.{t}"] = torch.zeros((1, 1, dim), dtype=torch.float32)
    for idx in range(cfg.num_ref_embeddings or 0):
        if f"ref_embeddings.ref_{idx}" not in out:
            out[f"ref_embeddings.ref_{idx}"] = torch.zeros((1, 1, dim), dtype=torch.float32)
    return out


# --- copied from vap_tpu/training/specs.py:139-165 --------------------------
def build_wan_mot_state_dict_from_base(sd: Mapping, cfg) -> StateDict:
    """Clone a plain Wan checkpoint's weights into the MoT expert branch
    (reference WanModelSpecification.load_diffusion_models,
    wan/base_specification.py:599-633: every `X_mot_ref` parameter is
    initialized from its base `X`; shapes always match for the supported
    configs since the reference branch consumes the same 36-ch conditioning).
    No-op for keys already present (a finetuned MoT checkpoint keeps its
    trained branch)."""
    out = dict(sd)

    def clone(prefix: str):
        plen = len(prefix)
        for k in list(sd):
            if k == prefix or (k.startswith(prefix) and k[plen] == "."):
                tgt = prefix + "_mot_ref" + k[plen:]
                if tgt not in out:
                    out[tgt] = sd[k]

    clone("patch_embedding")
    clone("condition_embedder")
    for i in cfg.block_idx_with_mot_ref:
        for sub in ("attn1", "attn2", "norm2", "ffn", "scale_shift_table"):
            clone(f"blocks.{i}.{sub}")
    if cfg.reference_train_mode == "reference_independent":
        clone("proj_out")
        clone("scale_shift_table")
    return out
