"""Attention dispatch: one full-attention op with pluggable providers.

Port of ``vap_tpu/ops/attention.py:41-110,163-202,206-299``. Providers:

  * "flash" — K1 (head_dim < 128) or K4 (head_dim 128), the hand-written bf16
    flash forward (``ops/flash_attention.py``), K7 when the call passes
    ``kv_lens`` and K8 when it passes ``segment_ids``; differentiable, with
    K5 or K6 as its backward (given ``kv_lens``: K7's backward, dk and dv
    zero past each length; given ``segment_ids``: K8's backward).
    "flash_varlen" and "jax_flash" (JAX's own library kernel there, not a
    kernel of the repo) take the same kernels;
  * "sage"  — K2, the int8-QK SageAttention-style forward, K7's int8 form
    with ``kv_lens`` (inference only: raises when a gradient is wanted);
    with ``segment_ids`` the bf16 K8, forward and backward, as in JAX;
  * "xla"   — plain PyTorch dense attention (the name is the JAX package's),
    ``dense_attention_masked`` with ``kv_lens``, ``dense_attention_segmented``
    with ``segment_ids``, differentiated by autograd;
  * "null"  — profiling only: skips the attention math (raises when a
    gradient is wanted; ignores ``segment_ids``, as in JAX);
  * "ring"  — sequence-parallel attention over the mesh installed with
    ``vap_tpu_torch.parallel.attention_mesh`` (``sequence_parallel_attention``:
    allgather, ppermute or ulysses), the local kernel (K1/K4, K7, K8) when
    none is; differentiable, each method's backward running the adjoint
    collectives (sequence-parallel training).

``kv_lens`` ([B] int) gives per-sample valid key counts (suffix padding);
``segment_ids`` ((q_seg [B, Sq], kv_seg [B, Skv], num_segments)) packed
sequences, query i attending key j iff their ids match; the two together
raise, as in JAX.

The default is "flash", as on the TPU and for training (the JAX trainer's
``attn_provider_training="auto"``); on CPU tensors the kernel wrappers run
their plain versions. Selection is thread-local and set with the
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

from ..parallel.ring_attention import get_attention_mesh, sequence_parallel_attention
from .flash_attention import (flash_attention, flash_attention_int8, flash_attention_segmented,
                              wants_grad)

_state = threading.local()

_VALID_PROVIDERS = ("flash", "flash_varlen", "sage", "jax_flash", "xla", "ring", "null")
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


def dense_attention_masked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_lens: Optional[torch.Tensor] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Plain dense attention with per-sample valid key counts: f32 scores
    and f32 P V; keys at or past kv_lens[b] get the finite bias -1e30, and a
    sample with no valid key gets exact zero rows (``vap_tpu/ops/attention.py:163-188``)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    if kv_lens is not None:
        lens = kv_lens.to(device=q.device, dtype=torch.int64)
        keep = torch.arange(k.shape[2], device=q.device)[None, :] < lens[:, None]
        s = s + torch.where(keep, 0.0, -1e30)[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    if kv_lens is not None:
        p = p * (lens > 0).float()[:, None, None, None]
    return (p @ v.float()).to(v.dtype)


def dense_attention_segmented(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              q_segment_ids: torch.Tensor, kv_segment_ids: torch.Tensor,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Plain dense attention over packed sequences: query i attends key j iff
    q_segment_ids[b, i] == kv_segment_ids[b, j]; f32 scores and f32 P V; a
    query with no matching key gets zero rows
    (``vap_tpu/ops/attention.py:191-202``)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    same = (q_segment_ids.to(q.device)[:, :, None]
            == kv_segment_ids.to(q.device)[:, None, :])  # [B, Sq, Skv]
    s = s + torch.where(same, 0.0, -1e30)[:, None]
    p = torch.softmax(s, dim=-1) * same.any(dim=-1).float()[:, None, :, None]
    return (p @ v.float()).to(v.dtype)


def _ring(q, k, v, scale, kv_lens, segment_ids):
    """The "ring" provider: sequence-parallel attention over the installed
    mesh, or the local kernel when none is (``vap_tpu/ops/attention.py:276-298``);
    differentiable either way."""
    ctx = get_attention_mesh()
    if ctx is not None:
        mesh, axis, rotate_method = ctx
        return sequence_parallel_attention(q, k, v, mesh, axis, scale, rotate_method,
                                           kv_lens=kv_lens, segment_ids=segment_ids)
    if segment_ids is not None:
        return flash_attention_segmented(q, k, v, *segment_ids, scale)
    return flash_attention(q, k, v, scale, kv_lens)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: Optional[float] = None,
                   provider: Optional[str] = None,
                   site: str = "default",
                   kv_lens: Optional[torch.Tensor] = None,
                   segment_ids: Optional[tuple] = None) -> torch.Tensor:
    """Full (non-causal) attention over [B, H, S, D] tensors: the JAX
    package's ``scaled_dot_product_attention``. ``kv_lens`` ([B] int) masks
    each sample's keys at or past its length (K7 under the kernel
    providers); queries are never masked. ``segment_ids`` ((q_seg, kv_seg,
    num_segments)) masks every query-key pair whose ids differ (K8 under
    the kernel providers)."""
    provider = provider or get_attention_provider(site)
    if segment_ids is not None and kv_lens is not None:
        raise ValueError("segment_ids and kv_lens are mutually exclusive; give padding its "
                         "own out-of-range segment id")
    if provider == "ring":
        return _ring(q, k, v, scale, kv_lens, segment_ids)
    if segment_ids is not None and provider in ("flash", "flash_varlen", "jax_flash", "sage"):
        # sage too: its int8 scores take no segment mask in JAX either, which
        # sends packed segments to the bf16 kernel (attention.py:250-255)
        return flash_attention_segmented(q, k, v, *segment_ids, scale)
    if provider in ("flash", "flash_varlen", "jax_flash"):
        return flash_attention(q, k, v, scale, kv_lens)
    if provider == "sage":
        return flash_attention_int8(q, k, v, scale, kv_lens)
    if provider == "xla":
        if segment_ids is not None:
            return dense_attention_segmented(q, k, v, segment_ids[0], segment_ids[1], scale)
        if kv_lens is not None:
            return dense_attention_masked(q, k, v, kv_lens, scale)
        return dense_attention(q, k, v, scale)
    if provider == "null":
        if wants_grad(q, k, v):
            raise NotImplementedError("the null attention provider is for profiling only "
                                      "and has no gradient")
        # keeps a data dependency on q and k, as the JAX provider does
        eps = torch.tensor(1e-30, dtype=q.dtype, device=q.device)
        if v.shape[2] == q.shape[2]:
            return v + (q + k) * eps
        return v[:, :, :1].expand_as(q).to(q.dtype) + (q + k[:, :, :q.shape[2]]) * eps
    raise ValueError(f"unknown attention provider {provider!r}")
