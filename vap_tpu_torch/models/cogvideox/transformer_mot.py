"""CogVideoX MoT diffusion transformer in PyTorch.

Port of ``vap_tpu/models/cogvideox/transformer_mot.py:102-620``: a
CogVideoX DiT trunk plus a Mixture-of-Transformers reference branch whose
tokens (clean reference-video latents) join the target tokens inside one
full attention per block, with temporally biased RoPE on the reference
tokens. Blocks listed in ``block_idx_with_mot_ref`` are joint MoT blocks;
the others are plain trunk blocks (the released structure: MoT in 0-40 of
42).

Without reference inputs the forward runs the base trunk alone over
``hidden_states`` (``cogvideox_mot_forward(single_branch=True)``, :597-620):
the MoT blocks skip their expert and no reference stream is built. The
pipeline's plain, T2V and single-branch ablation modes call it so.

The forward is ``prologue`` (time embeddings, patchify, the reference
slot and effect embeddings), ``run_blocks`` over a range of blocks (the
streamed offload runs it one chunk at a time, ``pipelines/streamed.py``)
and ``epilogue`` (the output head, and with ``reference_independent`` the
reference stream's own head), as ``cog_prologue``, ``cog_run_segment`` and
``cog_epilogue`` of JAX (:466-579).

CogVideoX 1.5 (``patch_size_t``): the patch projection is a linear over
(C, pt, p, p)-ordered voxels and ``proj_out`` gives pt frames a token;
``ofs_embedding`` adds to both branches' time embeddings when the caller
gives ``ofs`` (the MoT forward only, as in JAX). The block ablations
(``ablation_single_encoder``, ``ablation_residual_addition``) run the
reference stream through its own sub-block first (:387-465).

Module attributes follow the diffusers state-dict keys of
``CogVideoXTransformer3DMOTModel`` (``transformer_blocks.{i}.attn1.to_q``,
``patch_embed.proj``, ``effect_embeddings.<type>``, ``ref_embeddings.ref_<i>``,
...), so a checkpoint loads with ``load_state_dict``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ...ops.attention import full_attention
from ...ops.rope import apply_rotary_emb
from ..common import (FeedForward, FP32LayerNorm, TimestepEmbedding, get_3d_sincos_pos_embed,
                      run_block, segments_plan, silu, stored, sinusoidal_timestep_embedding)
from .config import CogVideoXMOTConfig

Rope = Optional[Tuple[torch.Tensor, torch.Tensor]]


def sincos_pos_embedding(cfg: CogVideoXMOTConfig, height: int, width: int,
                         num_latent_frames: int) -> np.ndarray:
    """Joint [text zeros ‖ 3D sincos] table [L, D] at the given latent dims
    (CogVideoXPatchEmbed._get_positional_embeddings)."""
    ps = cfg.patch_size
    video = get_3d_sincos_pos_embed(cfg.inner_dim, (width // ps, height // ps), num_latent_frames,
                                    cfg.spatial_interpolation_scale,
                                    cfg.temporal_interpolation_scale)
    out = np.zeros((cfg.max_text_seq_length + video.shape[0], cfg.inner_dim), np.float32)
    out[cfg.max_text_seq_length:] = video
    return out


class CogVideoXPatchEmbed(nn.Module):
    """Text projection + patchify of the video (2D, or with ``patch_size_t``
    over pt frames too), concatenated along tokens, plus the learned joint
    position table when the config has one."""

    def __init__(self, cfg: CogVideoXMOTConfig):
        super().__init__()
        self.cfg = cfg
        ps, pt = cfg.patch_size, cfg.patch_size_t
        if pt is None:
            self.proj = nn.Conv2d(cfg.in_channels, cfg.inner_dim, kernel_size=ps, stride=ps)
        else:
            self.proj = nn.Linear(cfg.in_channels * pt * ps * ps, cfg.inner_dim)
        self.text_proj = nn.Linear(cfg.text_embed_dim, cfg.inner_dim)
        if cfg.use_learned_positional_embeddings:
            frames = (cfg.sample_frames - 1) // cfg.temporal_compression_ratio + 1
            pos = sincos_pos_embedding(cfg, cfg.sample_height, cfg.sample_width, frames)
            # a parameter, as in the JAX tree: ``trainable_mask`` trains the
            # reference branch's table (``patch_embed_mot_ref``) with the expert
            pos = torch.from_numpy(pos)[None].to(torch.get_default_dtype())
            self.pos_embedding = nn.Parameter(pos)

    def forward(self, text: torch.Tensor, video: torch.Tensor) -> torch.Tensor:
        """text [B, T, D_text], video [B, F, C, H, W] -> [B, T + F*h*w, D]."""
        cfg = self.cfg
        b, f, c, h, w = video.shape
        ps, pt = cfg.patch_size, cfg.patch_size_t or 1
        if cfg.patch_size_t is None:
            # conv2d(k = s = p) as a linear over (C, ph, pw)-ordered patch pixels
            x = video.reshape(b, f, c, h // ps, ps, w // ps, ps).permute(0, 1, 3, 5, 2, 4, 6)
        else:
            # a linear over (C, pt, ph, pw)-ordered voxels (:198-205)
            x = video.permute(0, 1, 3, 4, 2).reshape(b, f // pt, pt, h // ps, ps, w // ps, ps, c)
            x = x.permute(0, 1, 3, 5, 7, 2, 4, 6)
        x = x.reshape(b, (f // pt) * (h // ps) * (w // ps), c * pt * ps * ps)
        video_tokens = nn.functional.linear(x, stored(self.proj.weight, x.dtype).flatten(1),
                                            stored(self.proj.bias, x.dtype))
        tokens = torch.cat([self.text_proj(text), video_tokens], dim=1)
        if cfg.use_learned_positional_embeddings:
            pos = self.pos_embedding[0]
            if pos.shape[0] != tokens.shape[1]:
                # the reference swaps in a fresh sincos table at another frame
                # count and rejects other spatial sizes (embeddings.py:734-755)
                if (h, w) != (cfg.sample_height, cfg.sample_width):
                    raise ValueError(
                        "learned positional embeddings fix the spatial resolution to "
                        f"{cfg.sample_height}x{cfg.sample_width} latents, got {h}x{w}")
                pos = torch.from_numpy(sincos_pos_embedding(cfg, h, w, f // pt)).to(tokens.device)
            tokens = tokens + pos[None].to(tokens.dtype)
        return tokens


class CogVideoXLayerNormZero(nn.Module):
    """Six modulation chunks from linear(silu(temb)) plus the shared LayerNorm."""

    def __init__(self, cond_dim: int, dim: int, eps: float):
        super().__init__()
        self.linear = nn.Linear(cond_dim, 6 * dim)
        self.norm = FP32LayerNorm(dim, eps=eps)

    def mods(self, temb: torch.Tensor):
        return self.linear(silu(temb)).chunk(6, dim=-1)


class Attention(nn.Module):
    """diffusers Attention of CogVideoX: q/k/v/out projections and per-head
    qk LayerNorm (eps 1e-6)."""

    def __init__(self, dim: int, heads: int, head_dim: int, bias: bool):
        super().__init__()
        inner = heads * head_dim
        self.heads = heads
        self.to_q = nn.Linear(dim, inner, bias=bias)
        self.to_k = nn.Linear(dim, inner, bias=bias)
        self.to_v = nn.Linear(dim, inner, bias=bias)
        self.to_out = nn.ModuleList([nn.Linear(inner, dim, bias=True), nn.Identity()])
        self.norm_q = FP32LayerNorm(head_dim, eps=1e-6)
        self.norm_k = FP32LayerNorm(head_dim, eps=1e-6)

    def qkv(self, x: torch.Tensor, rope: Rope, text_len: int):
        """x [B, S, D] (text ‖ video) -> q, k, v [B, H, S, Dh], contiguous,
        with RoPE on the video tokens (an identity rotation over the text)."""
        b, s, _ = x.shape
        q = self.norm_q(self.to_q(x).unflatten(-1, (self.heads, -1))).transpose(1, 2)
        k = self.norm_k(self.to_k(x).unflatten(-1, (self.heads, -1))).transpose(1, 2)
        v = self.to_v(x).unflatten(-1, (self.heads, -1)).transpose(1, 2)
        if rope is not None:
            cos, sin = rope
            cos = torch.cat([cos.new_ones((text_len, cos.shape[1])), cos])
            sin = torch.cat([sin.new_zeros((text_len, sin.shape[1])), sin])
            q = apply_rotary_emb(q, cos, sin)
            k = apply_rotary_emb(k, cos, sin)
        return q.contiguous(), k.contiguous(), v.contiguous()

    def out(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, H, S, Dh] -> [B, S, D]."""
        return self.to_out[0](x.transpose(1, 2).flatten(2))


def _per_ref(x: torch.Tensor, r: int) -> torch.Tensor:
    """[B, R*S, D] -> [B, R, S, D]."""
    return x.unflatten(1, (r, -1))


def _modulate(norm: FP32LayerNorm, x, scale, shift):
    return norm(x) * (1 + scale[:, None]) + shift[:, None]


class CogVideoXBlock(nn.Module):
    """One transformer block; the joint MoT block when ``with_mot``
    (CogVideoXBlock.forward, cogvideox_transformer_3d_mot.py:375-513)."""

    def __init__(self, cfg: CogVideoXMOTConfig, with_mot: bool):
        super().__init__()
        dim = cfg.inner_dim
        self.with_mot = with_mot
        self.single_encoder = cfg.ablation_single_encoder
        self.residual_addition = cfg.ablation_residual_addition

        def branch(suffix: str):
            setattr(self, f"norm1{suffix}", CogVideoXLayerNormZero(cfg.time_embed_dim, dim, cfg.norm_eps))
            setattr(self, f"attn1{suffix}", Attention(dim, cfg.num_attention_heads,
                                                      cfg.attention_head_dim, cfg.attention_bias))
            setattr(self, f"norm2{suffix}", CogVideoXLayerNormZero(cfg.time_embed_dim, dim, cfg.norm_eps))
            setattr(self, f"ff{suffix}", FeedForward(dim))

        branch("")
        if with_mot:
            branch("_mot_ref")

    def _ff(self, hs, ehs, temb, suffix: str = ""):
        text_len = ehs.shape[1]
        norm2 = getattr(self, f"norm2{suffix}")
        shift, scale, gate, e_shift, e_scale, e_gate = norm2.mods(temb)
        nhs = _modulate(norm2.norm, hs, scale, shift)
        nehs = _modulate(norm2.norm, ehs, e_scale, e_shift)
        ff = getattr(self, f"ff{suffix}")(torch.cat([nehs, nhs], dim=1))
        return hs + gate[:, None] * ff[:, text_len:], ehs + e_gate[:, None] * ff[:, :text_len]

    def _self_attention(self, hs, ehs, temb, rope: Rope, suffix: str = ""):
        """A whole plain sub-block (attention over [text ‖ video], then the
        feed-forward) on the weights of branch ``suffix``."""
        text_len = ehs.shape[1]
        norm1, attn1 = getattr(self, f"norm1{suffix}"), getattr(self, f"attn1{suffix}")
        shift, scale, gate, e_shift, e_scale, e_gate = norm1.mods(temb)
        nhs = _modulate(norm1.norm, hs, scale, shift)
        nehs = _modulate(norm1.norm, ehs, e_scale, e_shift)
        q, k, v = attn1.qkv(torch.cat([nehs, nhs], dim=1), rope, text_len)
        attn = attn1.out(full_attention(q, k, v))
        hs = hs + gate[:, None] * attn[:, text_len:]
        ehs = ehs + e_gate[:, None] * attn[:, :text_len]
        return self._ff(hs, ehs, temb, suffix)

    def _forward_ablation(self, hs, ehs, temb, rope: Rope, hs_ref, ehs_ref, temb_ref,
                          rope_ref: Rope):
        """The ablation blocks (``_block_forward_ablation``, :387-465, one
        reference): the reference stream runs its own sub-block first, under
        the TARGET's RoPE table as the reference does; then the target's
        attention either takes the updated reference tokens into its
        sequence (single_encoder, the two tables concatenated) or runs alone
        and, after the feed-forward, adds the reference stream
        (residual_addition)."""
        hs_ref, ehs_ref = self._self_attention(hs_ref, ehs_ref, temb_ref[:, 0], rope, "_mot_ref")
        if not self.single_encoder:
            hs, ehs = self._self_attention(hs, ehs, temb, rope)
            return hs + hs_ref, ehs + ehs_ref, hs_ref, ehs_ref
        text_len, vid_len = ehs.shape[1], hs.shape[1]
        hs_cat, ehs_cat = torch.cat([hs, hs_ref], dim=1), torch.cat([ehs, ehs_ref], dim=1)
        rope_cat = (torch.cat([rope[0], rope_ref[0]]), torch.cat([rope[1], rope_ref[1]]))
        cat_text_len = ehs_cat.shape[1]
        shift, scale, gate, e_shift, e_scale, e_gate = self.norm1.mods(temb)
        nh = _modulate(self.norm1.norm, hs_cat, scale, shift)
        ne = _modulate(self.norm1.norm, ehs_cat, e_scale, e_shift)
        q, k, v = self.attn1.qkv(torch.cat([ne, nh], dim=1), rope_cat, cat_text_len)
        attn = self.attn1.out(full_attention(q, k, v))
        hs = hs + gate[:, None] * attn[:, cat_text_len:cat_text_len + vid_len]
        ehs = ehs + e_gate[:, None] * attn[:, :text_len]
        hs, ehs = self._ff(hs, ehs, temb)
        return hs, ehs, hs_ref, ehs_ref

    def forward(self, hs, ehs, temb, rope: Rope, hs_ref=None, ehs_ref=None, temb_ref=None,
                rope_ref: Rope = None, num_mot_ref: int = 1):
        if not self.with_mot or hs_ref is None:
            hs, ehs = self._self_attention(hs, ehs, temb, rope)
            return hs, ehs, hs_ref, ehs_ref
        if self.single_encoder or self.residual_addition:
            return self._forward_ablation(hs, ehs, temb, rope, hs_ref, ehs_ref, temb_ref, rope_ref)

        text_len = ehs.shape[1]
        shift, scale, gate, e_shift, e_scale, e_gate = self.norm1.mods(temb)
        nhs = _modulate(self.norm1.norm, hs, scale, shift)
        nehs = _modulate(self.norm1.norm, ehs, e_scale, e_shift)
        r = num_mot_ref
        ref_text_len = ehs_ref.shape[1]
        # per-ref modulation of the reference branch: temb_ref [B, R, E]
        r_shift, r_scale, r_gate, re_shift, re_scale, re_gate = self.norm1_mot_ref.mods(temb_ref)
        norm = self.norm1_mot_ref.norm
        nhs_ref = (norm(_per_ref(hs_ref, r)) * (1 + r_scale[:, :, None]) + r_shift[:, :, None]).flatten(1, 2)
        nehs_ref = (norm(_per_ref(ehs_ref, r)) * (1 + re_scale[:, :, None]) + re_shift[:, :, None]).flatten(1, 2)

        q, k, v = self.attn1.qkv(torch.cat([nehs, nhs], dim=1), rope, text_len)
        q_r, k_r, v_r = self.attn1_mot_ref.qkv(torch.cat([nehs_ref, nhs_ref], dim=1), rope_ref,
                                               ref_text_len)
        attn = full_attention(torch.cat([q, q_r], dim=2), torch.cat([k, k_r], dim=2),
                                            torch.cat([v, v_r], dim=2), site="joint")
        tgt_len = text_len + hs.shape[1]
        attn_t = self.attn1.out(attn[:, :, :tgt_len])
        attn_r = self.attn1_mot_ref.out(attn[:, :, tgt_len:])
        hs = hs + gate[:, None] * attn_t[:, text_len:]
        ehs = ehs + e_gate[:, None] * attn_t[:, :text_len]
        hs, ehs = self._ff(hs, ehs, temb)

        # reference branch residuals and feed-forward with per-ref gates
        hs_ref = (_per_ref(hs_ref, r) + r_gate[:, :, None] * _per_ref(attn_r[:, ref_text_len:], r)).flatten(1, 2)
        ehs_ref = (_per_ref(ehs_ref, r) + re_gate[:, :, None] * _per_ref(attn_r[:, :ref_text_len], r)).flatten(1, 2)
        r_shift2, r_scale2, r_gate2, re_shift2, re_scale2, re_gate2 = self.norm2_mot_ref.mods(temb_ref)
        norm = self.norm2_mot_ref.norm
        nhs_ref = (norm(_per_ref(hs_ref, r)) * (1 + r_scale2[:, :, None]) + r_shift2[:, :, None]).flatten(1, 2)
        nehs_ref = (norm(_per_ref(ehs_ref, r)) * (1 + re_scale2[:, :, None]) + re_shift2[:, :, None]).flatten(1, 2)
        ff_ref = self.ff_mot_ref(torch.cat([nehs_ref, nhs_ref], dim=1))
        hs_ref = (_per_ref(hs_ref, r) + r_gate2[:, :, None] * _per_ref(ff_ref[:, ref_text_len:], r)).flatten(1, 2)
        ehs_ref = (_per_ref(ehs_ref, r) + re_gate2[:, :, None] * _per_ref(ff_ref[:, :ref_text_len], r)).flatten(1, 2)
        return hs, ehs, hs_ref, ehs_ref


class _AdaLayerNorm(nn.Module):
    """Output modulation: shift, scale = linear(silu(temb)); norm(x)*(1+scale)+shift."""

    def __init__(self, cond_dim: int, dim: int, eps: float):
        super().__init__()
        self.linear = nn.Linear(cond_dim, 2 * dim)
        self.norm = FP32LayerNorm(dim, eps=eps)

    def forward(self, x, temb):
        shift, scale = self.linear(silu(temb)).chunk(2, dim=-1)
        return _modulate(self.norm, x, scale, shift)


class CogVideoXTransformer3DMOTModel(nn.Module):
    """The VAP transformer. ``forward`` returns the prediction [B, F, C_out, H, W]."""

    # read only when the checkpoint has it (``weights.py:112``)
    optional_checkpoint_modules = ("ofs_embedding",)

    def __init__(self, cfg: CogVideoXMOTConfig):
        super().__init__()
        self.config = cfg
        dim = cfg.inner_dim
        pt = cfg.patch_size_t or 1
        out_dim = cfg.patch_size * cfg.patch_size * pt * cfg.out_channels
        self.patch_embed = CogVideoXPatchEmbed(cfg)
        self.patch_embed_mot_ref = CogVideoXPatchEmbed(cfg)
        self.time_embedding = TimestepEmbedding(dim, cfg.time_embed_dim)
        self.time_embedding_mot_ref = TimestepEmbedding(dim, cfg.time_embed_dim)
        if cfg.ofs_embed_dim:
            self.ofs_embedding = TimestepEmbedding(cfg.ofs_embed_dim, cfg.ofs_embed_dim)
        mot = set(cfg.block_idx_with_mot_ref)
        self.transformer_blocks = nn.ModuleList(
            [CogVideoXBlock(cfg, i in mot) for i in range(cfg.num_layers)])
        self.norm_final = FP32LayerNorm(dim, eps=cfg.norm_eps)
        self.norm_out = _AdaLayerNorm(cfg.time_embed_dim, dim, cfg.norm_eps)
        self.proj_out = nn.Linear(dim, out_dim)
        if cfg.reference_train_mode == "reference_independent":
            self.norm_final_mot_ref = FP32LayerNorm(dim, eps=cfg.norm_eps)
            self.norm_out_mot_ref = _AdaLayerNorm(cfg.time_embed_dim, dim, cfg.norm_eps)
            self.proj_out_mot_ref = nn.Linear(dim, out_dim)
        # keyed by the checkpoint's names, each [1, 1, D] as the JAX export
        # writes them (``vap_tpu/training/checkpoint.py:187-192``)
        if cfg.supported_effect_types:
            self.effect_embeddings = nn.ParameterDict(
                {t: nn.Parameter(torch.zeros(1, 1, dim)) for t in cfg.supported_effect_types})
        if cfg.num_ref_embeddings:
            self.ref_embeddings = nn.ParameterDict(
                {f"ref_{i}": nn.Parameter(torch.zeros(1, 1, dim))
                 for i in range(cfg.num_ref_embeddings)})

    def _time_embed(self, mlp: TimestepEmbedding, t: torch.Tensor, dtype,
                    dim: Optional[int] = None) -> torch.Tensor:
        cfg = self.config
        emb = sinusoidal_timestep_embedding(t, dim or cfg.inner_dim,
                                            flip_sin_to_cos=cfg.flip_sin_to_cos,
                                            downscale_freq_shift=cfg.freq_shift)
        return mlp(emb.to(dtype))

    @staticmethod
    def _stacked(table: nn.ParameterDict, names) -> torch.Tensor:
        """The embeddings ``names`` of ``table`` as one [N, D] tensor."""
        return torch.cat([table[n].reshape(1, -1) for n in names])

    def prologue(self, hidden_states: torch.Tensor, encoder_hidden_states: torch.Tensor,
                 timestep: torch.Tensor, image_rotary_emb: Rope,
                 hidden_states_mot_ref: Optional[torch.Tensor] = None,
                 encoder_hidden_states_mot_ref: Optional[torch.Tensor] = None,
                 image_rotary_emb_mot_ref: Rope = None, num_mot_ref: int = 1,
                 timestep_mot_ref: Optional[torch.Tensor] = None,
                 effect_ids: Optional[torch.Tensor] = None,
                 ofs: Optional[torch.Tensor] = None) -> Tuple[tuple, Dict]:
        """Time embeddings and patchify (``cog_prologue``, :466-526).
        Returns (carry, aux): carry = (hs, ehs, hs_ref, ehs_ref), the
        reference entries None without reference inputs (the trunk alone,
        which takes no ofs, as in JAX); aux what every block and the
        epilogue read."""
        cfg = self.config
        b, num_frames, _, height, width = hidden_states.shape
        t_text = encoder_hidden_states.shape[1]
        dtype = hidden_states.dtype
        r = num_mot_ref

        emb = self._time_embed(self.time_embedding, timestep, dtype)
        tokens = self.patch_embed(encoder_hidden_states, hidden_states)
        ehs, hs = tokens[:, :t_text], tokens[:, t_text:]
        aux = {"emb": emb, "rope": image_rotary_emb, "emb_ref": None, "rope_ref": None,
               "num_mot_ref": r, "shape": (num_frames, height, width)}
        if hidden_states_mot_ref is None:
            return (hs, ehs, None, None), aux

        if timestep_mot_ref is None:
            timestep_mot_ref = timestep[:, None].expand(b, r)
        emb_ref = self._time_embed(self.time_embedding_mot_ref, timestep_mot_ref.reshape(-1),
                                   dtype).reshape(b, r, -1)
        if cfg.ofs_embed_dim and ofs is not None:
            if not hasattr(self, "ofs_embedding"):
                raise ValueError("ofs given, but the checkpoint had no ofs_embedding")
            ofs_emb = self._time_embed(self.ofs_embedding, ofs, dtype, cfg.ofs_embed_dim)
            emb = emb + ofs_emb
            emb_ref = emb_ref + ofs_emb[:, None]
        vid_ref = hidden_states_mot_ref.reshape(b * r, num_frames, *hidden_states_mot_ref.shape[2:])
        txt_ref = encoder_hidden_states_mot_ref.reshape(b * r, t_text, -1)
        tokens_ref = self.patch_embed_mot_ref(txt_ref, vid_ref).reshape(b, r, -1, cfg.inner_dim)
        if cfg.num_ref_embeddings:
            # reference slot embeddings, back to front (:515-518)
            slots = self._stacked(self.ref_embeddings, [f"ref_{i}" for i in range(r - 1, -1, -1)])
            tokens_ref = tokens_ref + slots.to(dtype)[None, :, None, :]
        if cfg.supported_effect_types and effect_ids is not None:
            table = self._stacked(self.effect_embeddings, cfg.supported_effect_types).to(dtype)
            tokens_ref = tokens_ref + table[effect_ids][None, :, None, :]
        ehs_ref = tokens_ref[:, :, :t_text].reshape(b, r * t_text, cfg.inner_dim)
        hs_ref = tokens_ref[:, :, t_text:].reshape(b, -1, cfg.inner_dim)
        aux.update(emb=emb, emb_ref=emb_ref, rope_ref=image_rotary_emb_mot_ref)
        return (hs, ehs, hs_ref, ehs_ref), aux

    def run_blocks(self, carry, aux, remat: Union[bool, str] = False, start: int = 0,
                   stop: Optional[int] = None):
        """Blocks ``start`` to ``stop`` (all by default) over the carry
        (``cog_run_segment``) under ``remat`` (``remat_plan`` over each
        run of MoT or plain blocks, as JAX scans them)."""
        plan = segments_plan(remat, [length for _, length, _ in self.config.mot_segments])
        stop = len(self.transformer_blocks) if stop is None else stop
        for i in range(start, stop):
            carry = run_block(self.transformer_blocks[i], plan[i], carry[0], carry[1],
                              aux["emb"], aux["rope"], carry[2], carry[3], aux["emb_ref"],
                              aux["rope_ref"], aux["num_mot_ref"])
        return carry

    def _unpatchify(self, x: torch.Tensor, num_frames: int, height: int, width: int):
        """Output tokens -> [B, F, C_out, H, W] (``_unpatchify``, :224-242)."""
        cfg = self.config
        b, ps, pt = x.shape[0], cfg.patch_size, cfg.patch_size_t
        if pt is None:
            out = x.reshape(b, num_frames, height // ps, width // ps, -1, ps, ps)
            out = out.permute(0, 1, 4, 2, 5, 3, 6)
        else:
            out = x.reshape(b, (num_frames + pt - 1) // pt, height // ps, width // ps, -1, pt,
                            ps, ps)
            out = out.permute(0, 1, 5, 4, 2, 6, 3, 7)
        return out.reshape(b, num_frames, -1, height, width)

    def epilogue(self, carry, aux, reference_head: bool = True
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The output head (``cog_epilogue``, :551-579). Returns (the
        prediction, the reference stream's under ``reference_independent``
        with references and ``reference_head``, else None)."""
        num_frames, height, width = aux["shape"]
        hs = self.proj_out(self.norm_out(self.norm_final(carry[0]), aux["emb"]))
        out = self._unpatchify(hs, num_frames, height, width)
        hs_ref = carry[2]
        if (hs_ref is None or not reference_head
                or self.config.reference_train_mode != "reference_independent"):
            return out, None
        r = aux["num_mot_ref"]
        shift, scale = self.norm_out_mot_ref.linear(silu(aux["emb_ref"])).chunk(2, dim=-1)
        hs_ref = self.norm_out_mot_ref.norm(_per_ref(self.norm_final_mot_ref(hs_ref), r))
        hs_ref = (hs_ref * (1 + scale[:, :, None]) + shift[:, :, None]).flatten(1, 2)
        return out, self._unpatchify(self.proj_out_mot_ref(hs_ref), num_frames * r, height, width)

    def forward(self, hidden_states: torch.Tensor, encoder_hidden_states: torch.Tensor,
                timestep: torch.Tensor, image_rotary_emb: Rope,
                hidden_states_mot_ref: Optional[torch.Tensor] = None,
                encoder_hidden_states_mot_ref: Optional[torch.Tensor] = None,
                image_rotary_emb_mot_ref: Rope = None, num_mot_ref: int = 1,
                timestep_mot_ref: Optional[torch.Tensor] = None,
                effect_ids: Optional[torch.Tensor] = None, ofs: Optional[torch.Tensor] = None,
                remat: Union[bool, str] = False) -> torch.Tensor:
        """hidden_states [B, F, C, H, W] (noisy ‖ image latents); text
        [B, T, D_text]; timestep [B]; refs [B, R*F, C, H, W] and
        [B, R*T, D_text]; timestep_mot_ref [B, R] defaults to the target's;
        effect_ids [R] indexes ``supported_effect_types``; ofs [B]. Without
        ``hidden_states_mot_ref`` the trunk runs alone over
        ``hidden_states`` (which the single-branch ablation makes target ‖
        references along frames, with the two RoPE tables concatenated).

        ``remat``: False, True / "full", "ops" or "block_skip:N"
        (``remat_plan``). The reference
        head's output of ``reference_independent`` is the second item of
        ``epilogue``'s result."""
        carry, aux = self.prologue(hidden_states, encoder_hidden_states, timestep,
                                   image_rotary_emb, hidden_states_mot_ref,
                                   encoder_hidden_states_mot_ref, image_rotary_emb_mot_ref,
                                   num_mot_ref, timestep_mot_ref, effect_ids, ofs)
        return self.epilogue(self.run_blocks(carry, aux, remat), aux, reference_head=False)[0]
