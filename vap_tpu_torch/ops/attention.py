"""Attention dispatch: one full-attention op with pluggable providers.

Port of ``vap_tpu/ops/attention.py:41-110,206-299``. Providers:

  * "flash" — K1 (head_dim < 128) or K4 (head_dim 128), the hand-written bf16
    flash forward (``ops/flash_attention.py``);
  * "sage"  — K2, the int8-QK SageAttention-style forward (inference only);
  * "xla"   — plain PyTorch dense attention (the name is the JAX package's);
  * "null"  — profiling only: skips the attention math.

The default is "flash", as on the TPU; on CPU tensors the kernel wrappers
run their plain versions. Selection is thread-local and set with the
``attention_provider`` context manager, with optional per-site overrides
("sage joint:flash", "sage cross:flash"). Sites: "joint" (the MoT joint
self-attention of CogVideoX and Wan), "cross" (Wan's text and image
cross-attentions) and "default" (the rest).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

from .flash_attention import flash_attention, flash_attention_int8

_state = threading.local()

_VALID_PROVIDERS = ("flash", "sage", "xla", "null")
DEFAULT_PROVIDER = "flash"


def _parse_provider_spec(spec: str) -> dict:
    """'sage' -> {'default': 'sage'}; 'sage joint:flash' -> per-site overrides.

    Sites: 'joint' (the MoT joint self-attention), 'cross' (Wan's
    cross-attentions) and 'default' (the rest)."""
    out = {}
    for part in spec.replace(",", " ").split():
        site, name = part.split(":", 1) if ":" in part else ("default", part)
        if name not in _VALID_PROVIDERS:
            raise ValueError(f"unknown attention provider {name!r}; valid: {_VALID_PROVIDERS}")
        out[site] = name
    if not out:
        raise ValueError(f"empty attention provider spec {spec!r}")
    return out


def get_attention_provider(site: str = "default") -> str:
    m = getattr(_state, "providers", None)
    if m:
        return m.get(site) or m.get("default") or DEFAULT_PROVIDER
    return DEFAULT_PROVIDER


@contextlib.contextmanager
def attention_provider(spec: str):
    """Select the attention provider for the block: a bare name ('sage') or a
    per-site spec ('sage joint:flash')."""
    m = _parse_provider_spec(spec)
    prev = getattr(_state, "providers", None)
    _state.providers = m
    try:
        yield
    finally:
        _state.providers = prev


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Plain dense attention over [B, H, S, D]: f32 scores and softmax,
    P cast to v's dtype for the P V product."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    return (p.to(v.dtype) @ v).to(q.dtype)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 scale: Optional[float] = None,
                                 provider: Optional[str] = None,
                                 site: str = "default") -> torch.Tensor:
    """Full (non-causal) attention over [B, H, S, D] tensors: the JAX
    package's ``scaled_dot_product_attention`` without kv_lens and segment_ids."""
    provider = provider or get_attention_provider(site)
    if provider == "flash":
        return flash_attention(q, k, v, scale)
    if provider == "sage":
        return flash_attention_int8(q, k, v, scale)
    if provider == "xla":
        return dense_attention(q, k, v, scale)
    if provider == "null":
        # keeps a data dependency on q and k, as the JAX provider does
        eps = torch.tensor(1e-30, dtype=q.dtype, device=q.device)
        if v.shape[2] == q.shape[2]:
            return v + (q + k) * eps
        return v[:, :, :1].expand_as(q).to(q.dtype) + (q + k[:, :, :q.shape[2]]) * eps
    raise ValueError(f"unknown attention provider {provider!r}")
