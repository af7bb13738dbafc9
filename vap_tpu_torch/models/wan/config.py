"""Wan2.1 MoT transformer configuration.

Copied from ``vap_tpu/models/wan/config.py`` (``WanMOTConfig``), which
mirrors ``WanTransformer3DMOTModel`` (transformer_wan_mot.py:745-771).
``block_idx_with_mot_ref=()`` is the plain structure
(``WanTransformer3DModel``, the LoRA recipe's ``config_plain.json``):
no block and no prologue module of the MoT expert.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class WanMOTConfig:
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    num_attention_heads: int = 40
    attention_head_dim: int = 128
    in_channels: int = 16
    out_channels: int = 16
    text_dim: int = 4096
    freq_dim: int = 256
    ffn_dim: int = 13824
    num_layers: int = 40
    cross_attn_norm: bool = True
    eps: float = 1e-6
    image_dim: Optional[int] = None           # 1280 for I2V (CLIP vision)
    added_kv_proj_dim: Optional[int] = None   # inner_dim for I2V
    rope_max_seq_len: int = 1024
    pos_embed_seq_len: Optional[int] = None
    text_len: int = 512                       # UMT5 context length
    # mot
    block_idx_with_mot_ref: Tuple[int, ...] = (0, 10, 20)
    reference_train_mode: Optional[str] = None

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def mot_segments(self) -> Tuple[Tuple[int, int, bool], ...]:
        """Contiguous runs of blocks with and without MoT: (start, length, has_mot)."""
        mot = set(self.block_idx_with_mot_ref)
        segs, start, cur = [], 0, 0 in mot
        for i in range(1, self.num_layers):
            has = i in mot
            if has != cur:
                segs.append((start, i - start, cur))
                start, cur = i, has
        segs.append((start, self.num_layers - start, cur))
        return tuple(segs)

    @classmethod
    def wan_14b_i2v_vap(cls, **overrides) -> "WanMOTConfig":
        """ByteDance/Video-As-Prompt-Wan2.1-14B: 36-ch conditioning, MoT in all
        40 blocks (examples/training/sft/wan/vap_mot/config_ori.json)."""
        base = dict(
            in_channels=36, out_channels=16, image_dim=1280,
            added_kv_proj_dim=5120, block_idx_with_mot_ref=tuple(range(40)),
        )
        base.update(overrides)
        return cls(**base)

    @classmethod
    def wan_1_3b_t2v(cls, **overrides) -> "WanMOTConfig":
        """Wan-AI/Wan2.1-T2V-1.3B-Diffusers, the base model of the control
        trainer (``examples/training/control/wan/image_condition``): 30
        blocks, 12 heads of 128, ffn 8960, 16 input channels, no MoT block
        and no image cross-attention."""
        base = dict(
            num_attention_heads=12, attention_head_dim=128, in_channels=16,
            out_channels=16, ffn_dim=8960, num_layers=30,
            block_idx_with_mot_ref=(),
        )
        base.update(overrides)
        return cls(**base)

    @classmethod
    def tiny(cls, **overrides) -> "WanMOTConfig":
        base = dict(
            num_attention_heads=2, attention_head_dim=12, in_channels=4,
            out_channels=4, text_dim=8, freq_dim=16, ffn_dim=32, num_layers=2,
            image_dim=6, added_kv_proj_dim=24, text_len=7,
            block_idx_with_mot_ref=(0, 1), rope_max_seq_len=64,
        )
        base.update(overrides)
        return cls(**base)
