"""HunyuanVideo transformer configuration.

Copied from ``vap_tpu/models/hunyuan_video/config.py`` (``HunyuanVideoConfig``),
which mirrors diffusers' ``HunyuanVideoTransformer3DModel``
(transformer_hunyuan_video.py:875-935).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class HunyuanVideoConfig:
    in_channels: int = 16
    out_channels: int = 16
    num_attention_heads: int = 24
    attention_head_dim: int = 128
    num_layers: int = 20
    num_single_layers: int = 40
    num_refiner_layers: int = 2
    mlp_ratio: float = 4.0
    patch_size: int = 2
    patch_size_t: int = 1
    guidance_embeds: bool = True
    text_embed_dim: int = 4096
    pooled_projection_dim: int = 768
    rope_theta: float = 256.0
    rope_axes_dim: Tuple[int, ...] = (16, 56, 56)
    image_condition_type: Optional[str] = None  # None | "latent_concat" | "token_replace"

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @classmethod
    def hunyuan_video_t2v(cls, **overrides) -> "HunyuanVideoConfig":
        return cls(**overrides)

    @classmethod
    def tiny(cls, **overrides) -> "HunyuanVideoConfig":
        base = dict(in_channels=4, out_channels=4, num_attention_heads=2,
                    attention_head_dim=12, num_layers=2, num_single_layers=2,
                    num_refiner_layers=1, text_embed_dim=20,
                    pooled_projection_dim=16, rope_axes_dim=(4, 4, 4))
        base.update(overrides)
        return cls(**base)
