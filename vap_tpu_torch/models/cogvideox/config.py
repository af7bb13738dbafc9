"""CogVideoX MOT transformer configuration.

Copied from ``vap_tpu/models/cogvideox/config.py``. Field names and default
values mirror the reference model config (cogvideox_transformer_3d_mot.py:577-617)
so HF config JSONs map 1:1.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class CogVideoXMOTConfig:
    num_attention_heads: int = 30
    attention_head_dim: int = 64
    in_channels: int = 16
    out_channels: int = 16
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    time_embed_dim: int = 512
    ofs_embed_dim: Optional[int] = None
    text_embed_dim: int = 4096
    num_layers: int = 30
    attention_bias: bool = True
    sample_width: int = 90
    sample_height: int = 60
    sample_frames: int = 49
    patch_size: int = 2
    patch_size_t: Optional[int] = None
    temporal_compression_ratio: int = 4
    max_text_seq_length: int = 226
    norm_eps: float = 1e-5
    spatial_interpolation_scale: float = 1.875
    temporal_interpolation_scale: float = 1.0
    use_rotary_positional_embeddings: bool = True
    use_learned_positional_embeddings: bool = False
    # mot
    block_idx_with_mot_ref: Tuple[int, ...] = (0, 10, 20)
    supported_effect_types: Tuple[str, ...] = ()
    num_ref_embeddings: Optional[int] = None
    reference_train_mode: Optional[str] = None  # None | "reference_independent"
    # ablations (cogvideox_transformer_3d_mot.py:205-373)
    ablation_single_encoder: bool = False
    ablation_residual_addition: bool = False

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def mot_segments(self) -> Tuple[Tuple[int, int, bool], ...]:
        """Contiguous runs of blocks with equal MoT status: (start, length, has_mot).

        The JAX package stacks each segment's block params for one lax.scan;
        ``convert.from_jax_transformer`` unstacks them by these segments.
        """
        mot = set(self.block_idx_with_mot_ref)
        segs = []
        start = 0
        cur = 0 in mot
        for i in range(1, self.num_layers):
            has = i in mot
            if has != cur:
                segs.append((start, i - start, cur))
                start, cur = i, has
        segs.append((start, self.num_layers - start, cur))
        return tuple(segs)

    @classmethod
    def cogvideox_5b_i2v_vap(cls, **overrides) -> "CogVideoXMOTConfig":
        """ByteDance/Video-As-Prompt-CogVideoX-5B: 42 blocks, MoT in blocks
        0-40 — the released structure config lists 41 entries, leaving the
        last block plain (examples/training/sft/cogvideox/vap_mot/
        config_ori.json)."""
        base = dict(
            num_attention_heads=48,
            attention_head_dim=64,
            in_channels=32,
            out_channels=16,
            num_layers=42,
            text_embed_dim=4096,
            time_embed_dim=512,
            use_rotary_positional_embeddings=True,
            # the I2V base checkpoint carries a trained joint pos_embedding
            # buffer on top of RoPE (CogVideoX-5b-I2V config.json;
            # CogVideoXPatchEmbed, embeddings.py:671-674)
            use_learned_positional_embeddings=True,
            block_idx_with_mot_ref=tuple(range(41)),
        )
        base.update(overrides)
        return cls(**base)

    @classmethod
    def tiny(cls, **overrides) -> "CogVideoXMOTConfig":
        base = dict(
            num_attention_heads=2,
            attention_head_dim=16,
            in_channels=4,
            out_channels=4,
            time_embed_dim=16,
            text_embed_dim=8,
            num_layers=2,
            sample_width=8,
            sample_height=8,
            sample_frames=9,
            max_text_seq_length=6,
            block_idx_with_mot_ref=(0, 1),
        )
        base.update(overrides)
        return cls(**base)
