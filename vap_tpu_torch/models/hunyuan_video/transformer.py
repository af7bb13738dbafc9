"""HunyuanVideo transformer in PyTorch.

Port of ``vap_tpu/models/hunyuan_video/transformer.py:53-77,187-402``
(``hunyuan_video_forward``): 3D-patched latents, a token refiner over the
LLaMA embeddings (self-attention blocks conditioned on the timestep and the
mean-pooled text), 20 dual-stream blocks with joint [image ‖ text]
attention (image tokens lead; RoPE on image tokens only), 40 single-stream
blocks over the fused stream, guidance distilled into an embedding, an
AdaLN-continuous output and the unpatchify. ``image_condition_type``
"token_replace" modulates the first frame's tokens at t = 0;
"latent_concat" only widens ``in_channels``.

The joint attention goes through ``full_attention`` at the "joint" site
with ``kv_lens = S_img + sum(text mask)``: the text mask must be a
contiguous right-padded prefix (the pipeline checks it), so under the
kernel providers it runs K7, the varlen forward (60 launches a step at the
released depth), and under grad K7's backward. The refiner's attention is
the JAX package's plain ``_masked_attention`` (f32 scores, f32 P V).
``remat`` ("full", "ops", "block_skip:N") applies to the dual and the single blocks
(``scan_blocks_with_remat``, :397-399).

Module attributes follow the diffusers ``HunyuanVideoTransformer3DModel``
state-dict keys. Activations compute in the dtype of
``encoder_hidden_states`` (bf16 on the main path) with the JAX function's
float32 norms, modulations and gates.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.attention import full_attention
from ...ops.rope import apply_rotary_emb, get_1d_rotary_pos_embed
from ..common import (RMSNorm, TimestepEmbedding, gelu_tanh, layer_norm, remat_plan, run_block,
                      silu, sinusoidal_timestep_embedding, stored)
from .config import HunyuanVideoConfig

_EPS = 1e-6


# --- copied from vap_tpu/models/hunyuan_video/transformer.py:53-68 ----------
@functools.lru_cache(maxsize=8)
def _hunyuan_rope_np(axes_dim: Tuple[int, ...], theta: float, f: int, h: int, w: int):
    gf, gh, gw = np.meshgrid(np.arange(f, dtype=np.float32), np.arange(h, dtype=np.float32),
                             np.arange(w, dtype=np.float32), indexing="ij")
    cos_all, sin_all = [], []
    for dim_i, grid in zip(axes_dim, (gf, gh, gw)):
        cos, sin = get_1d_rotary_pos_embed(dim_i, grid.reshape(-1), theta=theta)
        cos_all.append(cos)
        sin_all.append(sin)
    return (np.concatenate(cos_all, axis=1).astype(np.float32),
            np.concatenate(sin_all, axis=1).astype(np.float32))


def hunyuan_rope(cfg: HunyuanVideoConfig, num_frames: int, height: int, width: int,
                 device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) each [S_img, head_dim] float32 over the post-patch grid
    (HunyuanVideoRotaryPosEmbed: theta 256, per-axis interleaved tables)."""
    cos, sin = _hunyuan_rope_np(tuple(cfg.rope_axes_dim), cfg.rope_theta,
                                num_frames // cfg.patch_size_t, height // cfg.patch_size,
                                width // cfg.patch_size)
    # torch.tensor copies: the cached numpy tables are shared between calls
    return torch.tensor(cos, device=device), torch.tensor(sin, device=device)


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, S, H*D] -> contiguous [B, H, S, D]."""
    return x.unflatten(-1, (heads, -1)).transpose(1, 2).contiguous()


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, S, D] -> [B, S, H*D]."""
    return x.transpose(1, 2).flatten(2)


def _sinu(t: torch.Tensor, dtype) -> torch.Tensor:
    return sinusoidal_timestep_embedding(t.float(), 256, flip_sin_to_cos=True,
                                         downscale_freq_shift=0.0).to(dtype)


def _modulate(x: torch.Tensor, shift, scale, dtype) -> torch.Tensor:
    """(LN(x) * (1 + scale) + shift) in float32, LN without affine rounded to
    x's dtype first, as the JAX function does."""
    return (layer_norm(x, None, None, _EPS).float() * (1 + scale) + shift).to(dtype)


class _Linear1(nn.Module):
    """A module holding one ``linear`` (the diffusers ``norm*.linear`` keys)."""

    def __init__(self, din: int, dout: int):
        super().__init__()
        self.linear = nn.Linear(din, dout)

    def mods(self, emb: torch.Tensor, n: int, dtype) -> List[torch.Tensor]:
        """``_mod6``: linear(silu(emb)) split in n float32 [B, 1, D] chunks."""
        m = self.linear(silu(emb.float()).to(dtype))
        return [c.float()[:, None] for c in m.chunk(n, dim=-1)]


class _Proj(nn.Module):
    """FeedForward's ``net.0`` holding ``proj``."""

    def __init__(self, din: int, dout: int):
        super().__init__()
        self.proj = nn.Linear(din, dout)


class _FeedForward(nn.Module):
    """diffusers FeedForward keys ``net.0.proj``, ``net.2``; ``act`` is
    gelu-tanh in the blocks and SiLU ("linear-silu") in the refiner."""

    def __init__(self, dim: int, inner: int, act):
        super().__init__()
        self.net = nn.ModuleList([_Proj(dim, inner), nn.Identity(), nn.Linear(inner, dim)])
        self.act = act

    def forward(self, x):
        return self.net[2](self.act(self.net[0].proj(x)))


class _TextProjection(nn.Module):
    """linear_1 -> SiLU -> linear_2 (diffusers PixArtAlphaTextProjection)."""

    def __init__(self, din: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(din, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(silu(self.linear_1(x)))


class _TimeTextEmbed(nn.Module):
    def __init__(self, dim: int, text_dim: int, guidance: bool = False):
        super().__init__()
        self.timestep_embedder = TimestepEmbedding(256, dim)
        self.text_embedder = _TextProjection(text_dim, dim)
        if guidance:
            self.guidance_embedder = TimestepEmbedding(256, dim)


class _Attention(nn.Module):
    def __init__(self, dim: int, head_dim: int, added: bool = False, pre_only: bool = False,
                 qk_norm: bool = True):
        super().__init__()
        self.to_q, self.to_k, self.to_v = (nn.Linear(dim, dim) for _ in range(3))
        if qk_norm:
            self.norm_q = RMSNorm(head_dim, _EPS)
            self.norm_k = RMSNorm(head_dim, _EPS)
        if not pre_only:
            self.to_out = nn.ModuleList([nn.Linear(dim, dim)])
        if added:
            self.add_q_proj, self.add_k_proj, self.add_v_proj = (nn.Linear(dim, dim)
                                                                 for _ in range(3))
            self.norm_added_q = RMSNorm(head_dim, _EPS)
            self.norm_added_k = RMSNorm(head_dim, _EPS)
            self.to_add_out = nn.Linear(dim, dim)


def _masked_attention(q, k, v, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The refiner's plain attention: f32 scores plus an additive bias, f32
    softmax and P V, cast to v's dtype."""
    s = (q.float() @ k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    if bias is not None:
        s = s + bias
    return (torch.softmax(s, dim=-1) @ v.float()).to(v.dtype)


class _RefinerBlock(nn.Module):
    def __init__(self, cfg: HunyuanVideoConfig):
        super().__init__()
        dim = cfg.inner_dim
        self.heads = cfg.num_attention_heads
        self.norm1 = nn.LayerNorm(dim, eps=_EPS)
        self.attn = _Attention(dim, cfg.attention_head_dim, qk_norm=False)
        self.norm2 = nn.LayerNorm(dim, eps=_EPS)
        self.ff = _FeedForward(dim, int(dim * cfg.mlp_ratio), silu)
        self.norm_out = _Linear1(dim, 2 * dim)

    def forward(self, x, temb, bias):
        a = self.attn
        n = layer_norm(x, self.norm1.weight, self.norm1.bias, _EPS)
        q, k, v = (_heads(p(n), self.heads) for p in (a.to_q, a.to_k, a.to_v))
        attn = a.to_out[0](_merge_heads(_masked_attention(q, k, v, bias)))
        gates = self.norm_out.linear(silu(temb.float()).to(x.dtype))
        g_msa, g_mlp = gates.chunk(2, dim=-1)
        x = x + attn * g_msa[:, None]
        h = self.ff(layer_norm(x, self.norm2.weight, self.norm2.bias, _EPS))
        return x + h * g_mlp[:, None]


class _TokenRefiner(nn.Module):
    """HunyuanVideoTokenRefiner (``_token_refiner``, :213-255)."""

    def __init__(self, cfg: HunyuanVideoConfig):
        super().__init__()
        self.time_text_embed = _TimeTextEmbed(cfg.inner_dim, cfg.text_embed_dim)
        self.proj_in = nn.Linear(cfg.text_embed_dim, cfg.inner_dim)
        self.token_refiner = nn.Module()
        self.token_refiner.refiner_blocks = nn.ModuleList(
            [_RefinerBlock(cfg) for _ in range(cfg.num_refiner_layers)])

    def forward(self, text, timestep, mask, dtype):
        if mask is None:
            pooled = text.mean(dim=1)
        else:
            mf = mask.float()[..., None]
            pooled = ((text.float() * mf).sum(dim=1) / mf.sum(dim=1)).to(text.dtype)
        tte = self.time_text_embed
        temb = tte.timestep_embedder(_sinu(timestep, dtype)) + tte.text_embedder(pooled.to(dtype))
        x = self.proj_in(text.to(dtype))
        bias = None
        if mask is not None:
            # pairwise AND of the token mask with column 0 forced on (:388-406)
            mb = mask > 0
            pair = mb[:, :, None] & mb[:, None, :]
            pair[:, :, 0] = True
            bias = torch.where(pair, 0.0, float("-inf"))[:, None]
        for block in self.token_refiner.refiner_blocks:
            x = block(x, temb, bias)
        return x


class _Mods:
    """The standard modulations, or with token_replace a per-token blend of
    them with the t = 0 ones (``_mods_tr``, :332-339)."""

    def __init__(self, temb, tr_temb, dtype):
        self.temb, self.tr_temb, self.dtype = temb, tr_temb, dtype

    def __call__(self, norm: _Linear1, n: int, sel: Optional[torch.Tensor]):
        std = norm.mods(self.temb, n, self.dtype)
        if self.tr_temb is None:
            return std
        tr = norm.mods(self.tr_temb, n, self.dtype)
        return [sel * t + (1.0 - sel) * s for s, t in zip(std, tr)]


class _DualBlock(nn.Module):
    def __init__(self, cfg: HunyuanVideoConfig):
        super().__init__()
        dim = cfg.inner_dim
        inner = int(dim * cfg.mlp_ratio)
        self.heads = cfg.num_attention_heads
        self.norm1 = _Linear1(dim, 6 * dim)
        self.norm1_context = _Linear1(dim, 6 * dim)
        self.attn = _Attention(dim, cfg.attention_head_dim, added=True)
        self.ff = _FeedForward(dim, inner, gelu_tanh)
        self.ff_context = _FeedForward(dim, inner, gelu_tanh)

    def forward(self, hs, enc, mods: _Mods, rope, kv_lens, sel):
        dtype, heads, a = hs.dtype, self.heads, self.attn
        sh, sc, g, sh_mlp, sc_mlp, g_mlp = mods(self.norm1, 6, sel)
        c_sh, c_sc, c_g, c_sh_mlp, c_sc_mlp, c_g_mlp = self.norm1_context.mods(mods.temb, 6, dtype)
        nhs = _modulate(hs, sh, sc, dtype)
        nenc = _modulate(enc, c_sh, c_sc, dtype)
        q = apply_rotary_emb(a.norm_q(_heads(a.to_q(nhs), heads)), *rope)
        k = apply_rotary_emb(a.norm_k(_heads(a.to_k(nhs), heads)), *rope)
        v = _heads(a.to_v(nhs), heads)
        qc = a.norm_added_q(_heads(a.add_q_proj(nenc), heads))
        kc = a.norm_added_k(_heads(a.add_k_proj(nenc), heads))
        vc = _heads(a.add_v_proj(nenc), heads)
        out = full_attention(torch.cat([q, qc], dim=2), torch.cat([k, kc], dim=2),
                             torch.cat([v, vc], dim=2), site="joint", kv_lens=kv_lens)
        out = _merge_heads(out)
        s_img = hs.shape[1]
        hs = hs + (a.to_out[0](out[:, :s_img]).float() * g).to(dtype)
        enc = enc + (a.to_add_out(out[:, s_img:]).float() * c_g).to(dtype)
        hs = hs + (self.ff(_modulate(hs, sh_mlp, sc_mlp, dtype)).float() * g_mlp).to(dtype)
        enc = enc + (self.ff_context(_modulate(enc, c_sh_mlp, c_sc_mlp, dtype)).float()
                     * c_g_mlp).to(dtype)
        return hs, enc


class _SingleBlock(nn.Module):
    def __init__(self, cfg: HunyuanVideoConfig):
        super().__init__()
        dim = cfg.inner_dim
        mlp = int(dim * cfg.mlp_ratio)
        self.heads = cfg.num_attention_heads
        self.norm = _Linear1(dim, 3 * dim)
        self.proj_mlp = nn.Linear(dim, mlp)
        self.proj_out = nn.Linear(dim + mlp, dim)
        self.attn = _Attention(dim, cfg.attention_head_dim, pre_only=True)

    def forward(self, x, mods: _Mods, rope, kv_lens, sel, s_img: int):
        dtype, heads, a = x.dtype, self.heads, self.attn
        shift, scale, gate = mods(self.norm, 3, sel)
        n = _modulate(x, shift, scale, dtype)
        mlp = gelu_tanh(self.proj_mlp(n))
        q = a.norm_q(_heads(a.to_q(n), heads))
        k = a.norm_k(_heads(a.to_k(n), heads))
        v = _heads(a.to_v(n), heads)
        q = torch.cat([apply_rotary_emb(q[:, :, :s_img], *rope), q[:, :, s_img:]], dim=2)
        k = torch.cat([apply_rotary_emb(k[:, :, :s_img], *rope), k[:, :, s_img:]], dim=2)
        attn = _merge_heads(full_attention(q, k, v, site="joint", kv_lens=kv_lens))
        out = self.proj_out(torch.cat([attn, mlp], dim=-1))
        return x + (out.float() * gate).to(dtype)


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: HunyuanVideoConfig):
        super().__init__()
        pt, p = cfg.patch_size_t, cfg.patch_size
        self.proj = nn.Conv3d(cfg.in_channels, cfg.inner_dim, (pt, p, p), stride=(pt, p, p))


class HunyuanVideoTransformer3DModel(nn.Module):
    def __init__(self, cfg: HunyuanVideoConfig):
        super().__init__()
        self.config = cfg
        dim = cfg.inner_dim
        pt, p = cfg.patch_size_t, cfg.patch_size
        self.x_embedder = _PatchEmbed(cfg)
        self.context_embedder = _TokenRefiner(cfg)
        self.time_text_embed = _TimeTextEmbed(dim, cfg.pooled_projection_dim,
                                              guidance=cfg.guidance_embeds)
        self.transformer_blocks = nn.ModuleList([_DualBlock(cfg) for _ in range(cfg.num_layers)])
        self.single_transformer_blocks = nn.ModuleList(
            [_SingleBlock(cfg) for _ in range(cfg.num_single_layers)])
        self.norm_out = _Linear1(dim, 2 * dim)
        self.proj_out = nn.Linear(dim, pt * p * p * cfg.out_channels)

    def forward(self, hidden_states: torch.Tensor, encoder_hidden_states: torch.Tensor,
                pooled_projections: torch.Tensor, timestep: torch.Tensor,
                guidance: Optional[torch.Tensor] = None,
                encoder_attention_mask: Optional[torch.Tensor] = None,
                remat: Union[bool, str] = False) -> torch.Tensor:
        """hidden_states [B, C, F, H, W] latents; encoder_hidden_states
        [B, S_txt, text_embed_dim]; pooled_projections [B, pooled dim];
        timestep [B] in [0, 1000]; guidance [B], already x1000;
        encoder_attention_mask [B, S_txt], a contiguous right-padded
        prefix of ones; ``remat`` False, True / "full", "ops" or
        "block_skip:N" (``remat_plan`` over the dual blocks, then over the
        single ones, as JAX scans them). Returns [B, out_channels, F, H, W]."""
        cfg = self.config
        b, c, f, h, w = hidden_states.shape
        pt, p = cfg.patch_size_t, cfg.patch_size
        dtype = encoder_hidden_states.dtype

        # 3D patchify == Conv3d with stride == kernel == a linear over (C, pt, p, p)
        x = hidden_states.reshape(b, c, f // pt, pt, h // p, p, w // p, p)
        x = x.permute(0, 2, 4, 6, 1, 3, 5, 7).reshape(b, -1, c * pt * p * p)
        proj = self.x_embedder.proj
        hs = F.linear(x.to(dtype), stored(proj.weight, dtype).flatten(1), stored(proj.bias, dtype))
        s_img = hs.shape[1]

        tte = self.time_text_embed
        pooled_emb = tte.text_embedder(pooled_projections.to(dtype))
        temb = tte.timestep_embedder(_sinu(timestep, dtype)) + pooled_emb
        tr_temb = None
        if cfg.image_condition_type == "token_replace":
            # first-frame tokens are conditioned at t = 0, without guidance
            tr_temb = tte.timestep_embedder(_sinu(torch.zeros_like(timestep), dtype)) + pooled_emb
        if cfg.guidance_embeds:
            g = guidance if guidance is not None else torch.full(
                (b,), 1000.0, dtype=torch.float32, device=hs.device)
            temb = temb + tte.guidance_embedder(_sinu(g, dtype))

        enc = self.context_embedder(encoder_hidden_states, timestep, encoder_attention_mask,
                                    dtype)
        s_txt = enc.shape[1]
        rope = hunyuan_rope(cfg, f, h, w, device=hs.device)

        # keys: [image (all valid) ‖ text valid prefix ‖ text padding]
        kv_lens = None
        if encoder_attention_mask is not None:
            kv_lens = s_img + encoder_attention_mask.to(torch.int32).sum(dim=-1, dtype=torch.int32)

        mods = _Mods(temb, tr_temb, dtype)
        sel_img = sel_full = None
        if tr_temb is not None:
            n_first = (h // p) * (w // p)
            pos = torch.arange(s_img + s_txt, device=hs.device)
            sel_full = (pos < n_first).float()[None, :, None]
            sel_img = sel_full[:, :s_img]

        for block, mode in zip(self.transformer_blocks,
                               remat_plan(remat, len(self.transformer_blocks))):
            hs, enc = run_block(block, mode, hs, enc, mods, rope, kv_lens, sel_img)
        x = torch.cat([hs, enc], dim=1)
        for block, mode in zip(self.single_transformer_blocks,
                               remat_plan(remat, len(self.single_transformer_blocks))):
            x = run_block(block, mode, x, mods, rope, kv_lens, sel_full, s_img)
        hs = x[:, :s_img]

        scale, shift = self.norm_out.mods(temb, 2, dtype)
        hs = self.proj_out(_modulate(hs, shift, scale, dtype))
        out = hs.reshape(b, f // pt, h // p, w // p, cfg.out_channels, pt, p, p)
        out = out.permute(0, 4, 1, 5, 2, 6, 3, 7)
        return out.reshape(b, cfg.out_channels, f, h, w)
