"""Wan2.1 MoT diffusion transformer in PyTorch.

Port of ``vap_tpu/models/wan/transformer_mot.py:54-100,269-610``, the
``WanTransformer3DMOTModel`` of Video-As-Prompt:

  * joint self-attention: per-branch Q/K/V (RMS norm across heads, Wan's
    interleaved-pair RoPE, the reference tokens at negative times)
    concatenated into one full attention (site "joint");
  * a cross-attention per branch to its own [UMT5 text ‖ CLIP image]
    context, the image keys through ``add_k_proj``/``add_v_proj``; with
    several references each attends only to its own context (site "cross");
  * scale-shift-table AdaLN with float32 layer norms;
  * the 36-channel conditioning input of image-to-video VAP.

With no MoT block (``block_idx_with_mot_ref=()``) it is the plain
``WanTransformer3DModel`` (``init_wan`` / ``wan_forward``, :200-266), which
builds no ``_mot_ref`` module; a forward without reference inputs runs the
trunk alone on any model, the MoT blocks' trunk halves included, with or
without the image context and conditioning channels (T2V).

The forward keeps the JAX package's channel-last layout, [B, F, H, W, C],
and is split into ``prologue``, the blocks (``run_blocks`` over a range:
the streamed offload runs it one chunk at a time) and ``epilogue`` as in
JAX. With ``reference_train_mode="reference_independent"`` the epilogue
also projects the reference stream through ``proj_out_mot_ref`` and
``scale_shift_table_mot_ref``: JAX's documented departure from the
reference, whose head projects the target stream (:13-15, :561-573).
Module attributes follow the diffusers state-dict keys
(``blocks.{i}.attn1.to_q``, ``condition_embedder.time_embedder.linear_1``,
``patch_embedding`` as a Conv3d, ...).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.attention import full_attention
from ..common import (FeedForward, FP32LayerNorm, RMSNorm, gelu_tanh, layer_norm,
                      run_block, segments_plan, silu, stored, sinusoidal_timestep_embedding)
from .config import WanMOTConfig

Rope = Tuple[torch.Tensor, torch.Tensor]


# ---------------------------------------------------------------------------
# RoPE: complex rotation over t/h/w splits, tables in float64 on the host
# --- copied from vap_tpu/models/wan/transformer_mot.py (_cis_1d, wan_rope)
# ---------------------------------------------------------------------------

def _cis_1d(dim: int, positions: np.ndarray, theta: float = 10000.0) -> np.ndarray:
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64)[: dim // 2] / dim))
    ang = np.outer(positions.astype(np.float64), freqs)  # [S, dim/2]
    return np.stack([np.cos(ang), np.sin(ang)], axis=-1)  # [S, dim/2, 2]


def wan_rope(cfg: WanMOTConfig, ppf: int, pph: int, ppw: int, *, negative_time: bool = False,
             total_ref_frames: Optional[int] = None, device=None) -> Rope:
    """(cos, sin), each [S, head_dim/2] float32, for patchified tokens.

    ``negative_time`` gives the reference table (WanRotaryPosEmbedRef): the
    temporal positions are arange(-total_ref_frames, ...)[:max_seq_len], so
    the references sit at negative times before the target."""
    d = cfg.attention_head_dim
    h_dim = w_dim = 2 * (d // 6)
    t_dim = d - h_dim - w_dim
    msl = cfg.rope_max_seq_len

    if negative_time:
        t_pos = np.arange(-(total_ref_frames if total_ref_frames is not None else ppf), msl)[:msl]
    else:
        t_pos = np.arange(msl)
    cis_t = _cis_1d(t_dim, t_pos)[:ppf]
    cis_h = _cis_1d(h_dim, np.arange(msl))[:pph]
    cis_w = _cis_1d(w_dim, np.arange(msl))[:ppw]

    def expand(c, axis):
        view = [1, 1, 1, c.shape[1], 2]
        view[axis] = c.shape[0]
        return np.broadcast_to(c.reshape(view), (ppf, pph, ppw, c.shape[1], 2))

    full = np.concatenate([expand(cis_t, 0), expand(cis_h, 1), expand(cis_w, 2)],
                          axis=3).reshape(ppf * pph * ppw, d // 2, 2)
    cos = torch.from_numpy(full[..., 0].astype(np.float32)).to(device)
    sin = torch.from_numpy(full[..., 1].astype(np.float32)).to(device)
    return cos, sin


def apply_wan_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Complex multiply over interleaved (even, odd) pairs, in float32.
    x [B, H, S, D]; cos, sin [S, D/2]. Not CogVideoX's rotate-half form."""
    xr = x.float().unflatten(-1, (-1, 2))
    xe, xo = xr[..., 0], xr[..., 1]
    out = torch.stack([xe * cos - xo * sin, xe * sin + xo * cos], dim=-1)
    return out.flatten(-2).to(x.dtype)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, S, H*D] -> contiguous [B, H, S, D]."""
    return x.unflatten(-1, (heads, -1)).transpose(1, 2).contiguous()


def _per_ref_heads(x: torch.Tensor, r: int) -> torch.Tensor:
    """[B, H, R*L, D] -> contiguous [B*R, H, L, D]."""
    b, h, rl, d = x.shape
    return x.reshape(b, h, r, rl // r, d).transpose(1, 2).reshape(b * r, h, rl // r, d).contiguous()


def _merge_ref_heads(x: torch.Tensor, r: int) -> torch.Tensor:
    """[B*R, H, L, D] -> [B, H, R*L, D]."""
    br, h, length, d = x.shape
    return x.reshape(br // r, r, h, length, d).transpose(1, 2).reshape(br // r, h, r * length, d)


class WanAttention(nn.Module):
    """Q/K/V/out projections with RMS norms across heads on Q and K; with
    ``added_kv`` the image-context K/V projections of the cross-attention."""

    def __init__(self, dim: int, heads: int, eps: float, added_kv: Optional[int] = None):
        super().__init__()
        self.heads = heads
        self.eps = eps
        self.to_q = nn.Linear(dim, dim)
        self.to_k = nn.Linear(dim, dim)
        self.to_v = nn.Linear(dim, dim)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim), nn.Identity()])
        self.norm_q = RMSNorm(dim, eps)
        self.norm_k = RMSNorm(dim, eps)
        if added_kv:
            self.add_k_proj = nn.Linear(added_kv, dim)
            self.add_v_proj = nn.Linear(added_kv, dim)
            self.norm_added_k = RMSNorm(dim, eps)

    def qkv(self, x: torch.Tensor, rope: Optional[Rope]):
        """Self-attention Q, K, V [B, H, S, D] (``_qkv``, :288-301)."""
        q = _heads(self.norm_q(self.to_q(x)), self.heads)
        k = _heads(self.norm_k(self.to_k(x)), self.heads)
        v = _heads(self.to_v(x), self.heads)
        if rope is not None:
            q = apply_wan_rope(q, *rope)
            k = apply_wan_rope(k, *rope)
        return q, k, v

    def out(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, S, D] -> [B, S, H*D]."""
        return self.to_out[0](x.transpose(1, 2).flatten(2))

    def cross(self, x: torch.Tensor, ctx_text: torch.Tensor, ctx_img: Optional[torch.Tensor],
              num_mot_ref: int = 1) -> torch.Tensor:
        """Cross-attention to text K/V plus, summed, CLIP-image K/V
        (``_cross_attention``, :309-353). With R references the queries and
        both contexts split into R equal groups, each attending its own."""
        r = num_mot_ref
        q = _heads(self.norm_q(self.to_q(x)), self.heads)

        def attend(ctx, kp, vp, knorm):
            k = _heads(knorm(kp(ctx)), self.heads)
            v = _heads(vp(ctx), self.heads)
            if r > 1:
                return _merge_ref_heads(full_attention(_per_ref_heads(q, r), _per_ref_heads(k, r),
                                                       _per_ref_heads(v, r), site="cross"), r)
            return full_attention(q, k, v, site="cross")

        out = attend(ctx_text, self.to_k, self.to_v, self.norm_k)
        if ctx_img is not None and hasattr(self, "add_k_proj"):
            out = out + attend(ctx_img, self.add_k_proj, self.add_v_proj, self.norm_added_k)
        return self.out(out)


class WanBlock(nn.Module):
    """``WanTransformerBlock`` (transformer_wan_mot.py:567-699); the joint
    MoT block when ``with_mot``."""

    def __init__(self, cfg: WanMOTConfig, with_mot: bool):
        super().__init__()
        dim, heads, eps = cfg.inner_dim, cfg.num_attention_heads, cfg.eps
        self.with_mot = with_mot
        self.eps = eps
        for s in ("", "_mot_ref") if with_mot else ("",):
            setattr(self, f"attn1{s}", WanAttention(dim, heads, eps))
            setattr(self, f"attn2{s}", WanAttention(dim, heads, eps, cfg.added_kv_proj_dim))
            # affine-free without cross_attn_norm, as in JAX (diffusers has no norm there)
            setattr(self, f"norm2{s}", FP32LayerNorm(dim, eps=eps,
                                                     elementwise_affine=cfg.cross_attn_norm))
            setattr(self, f"ffn{s}", FeedForward(dim, cfg.ffn_dim))
            setattr(self, f"scale_shift_table{s}", nn.Parameter(torch.zeros(1, 6, dim)))

    def _ln(self, x: torch.Tensor) -> torch.Tensor:
        """Affine-free float32 layer norm (norm1 and norm3); float32 out."""
        return layer_norm(x.float(), None, None, self.eps)

    @staticmethod
    def _cross_norm(norm: FP32LayerNorm, x: torch.Tensor) -> torch.Tensor:
        return norm(x.float()).to(x.dtype)

    def forward(self, hs, ctx_text, ctx_img, tproj, rope: Rope, hs_ref=None, ctx_text_ref=None,
                ctx_img_ref=None, tproj_ref=None, rope_ref: Optional[Rope] = None,
                num_mot_ref: int = 1):
        """tproj [B, 6, D] and tproj_ref [B, R, 6, D] in float32. Without
        ``hs_ref`` the block runs its trunk alone (``has_mot=False``)."""
        mods = self.scale_shift_table.float() + tproj  # [B, 6, D]
        shift, scale, gate, c_shift, c_scale, c_gate = (mods[:, i][:, None] for i in range(6))
        dtype = hs.dtype

        # 1. self-attention (joint when MoT)
        nhs = (self._ln(hs) * (1 + scale) + shift).to(dtype)
        if not self.with_mot or hs_ref is None:
            attn = self.attn1.out(full_attention(*self.attn1.qkv(nhs, rope)))
            hs = (hs.float() + attn.float() * gate).to(dtype)
            hs = hs + self.attn2.cross(self._cross_norm(self.norm2, hs), ctx_text, ctx_img)
            nhs = (self._ln(hs) * (1 + c_scale) + c_shift).to(dtype)
            hs = (hs.float() + self.ffn(nhs).float() * c_gate).to(dtype)
            return hs, hs_ref

        r = num_mot_ref
        b, s_ref = hs.shape[0], hs_ref.shape[1]
        mods_ref = self.scale_shift_table_mot_ref.float()[:, None] + tproj_ref  # [B, R, 6, D]
        (r_shift, r_scale, r_gate, rc_shift, rc_scale,
         rc_gate) = (mods_ref[:, :, i][:, :, None] for i in range(6))

        def per_ref(x):  # [B, R*S, D] -> [B, R, S, D]
            return x.reshape(b, r, s_ref // r, -1)

        def merge(x):
            return x.reshape(b, s_ref, -1)

        ref_dtype = hs_ref.dtype
        nref = merge(per_ref(self._ln(hs_ref)) * (1 + r_scale) + r_shift).to(ref_dtype)
        q, k, v = self.attn1.qkv(nhs, rope)
        q_r, k_r, v_r = self.attn1_mot_ref.qkv(nref, rope_ref)
        joint = full_attention(torch.cat([q, q_r], dim=2), torch.cat([k, k_r], dim=2),
                               torch.cat([v, v_r], dim=2), site="joint")
        s_t = hs.shape[1]
        attn = self.attn1.out(joint[:, :, :s_t])
        attn_ref = self.attn1_mot_ref.out(joint[:, :, s_t:])
        hs = (hs.float() + attn.float() * gate).to(dtype)
        hs_ref = (hs_ref.float() + merge(per_ref(attn_ref.float()) * r_gate)).to(ref_dtype)

        # 2. cross-attention: per branch, per-reference contexts
        nhs = self._cross_norm(self.norm2, hs)
        nref = self._cross_norm(self.norm2_mot_ref, hs_ref)
        hs = hs + self.attn2.cross(nhs, ctx_text, ctx_img)
        hs_ref = hs_ref + self.attn2_mot_ref.cross(nref, ctx_text_ref, ctx_img_ref, num_mot_ref=r)

        # 3. feed-forward
        nhs = (self._ln(hs) * (1 + c_scale) + c_shift).to(dtype)
        hs = (hs.float() + self.ffn(nhs).float() * c_gate).to(dtype)
        nref = merge(per_ref(self._ln(hs_ref)) * (1 + rc_scale) + rc_shift).to(ref_dtype)
        ff_ref = self.ffn_mot_ref(nref)
        hs_ref = (hs_ref.float() + merge(per_ref(ff_ref.float()) * rc_gate)).to(ref_dtype)
        return hs, hs_ref


class _MLP2(nn.Module):
    """linear_1 -> activation -> linear_2 (time and text embedders)."""

    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)


class _ImageFF(nn.Module):
    """diffusers FeedForward(mult=1, 'gelu'): keys net.0.proj and net.2."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        proj = nn.Module()
        proj.proj = nn.Linear(in_dim, in_dim)
        self.net = nn.ModuleList([proj, nn.Identity(), nn.Linear(in_dim, out_dim)])

    def forward(self, x):
        return self.net[2](F.gelu(self.net[0].proj(x)))


class WanImageEmbedding(nn.Module):
    """CLIP tokens -> model width: float32 LayerNorm, exact-GELU MLP,
    float32 LayerNorm; an optional learned position table (FLF2V)."""

    def __init__(self, cfg: WanMOTConfig):
        super().__init__()
        self.norm1 = FP32LayerNorm(cfg.image_dim, eps=1e-5)
        self.ff = _ImageFF(cfg.image_dim, cfg.inner_dim)
        self.norm2 = FP32LayerNorm(cfg.inner_dim, eps=1e-5)
        if cfg.pos_embed_seq_len:
            self.pos_embed = nn.Parameter(torch.zeros(1, cfg.pos_embed_seq_len, cfg.image_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "pos_embed"):
            _, s, d = x.shape
            x = x.reshape(-1, 2 * s, d) + self.pos_embed.to(x.dtype)
        x = self.norm1(x.float()).to(x.dtype)
        return self.norm2(self.ff(x).float()).to(x.dtype)


class WanConditionEmbedder(nn.Module):
    """``WanTimeTextImageEmbedding`` (transformer_wan_mot.py:275-312)."""

    def __init__(self, cfg: WanMOTConfig):
        super().__init__()
        self.freq_dim = cfg.freq_dim
        self.time_embedder = _MLP2(cfg.freq_dim, cfg.inner_dim)
        self.time_proj = nn.Linear(cfg.inner_dim, 6 * cfg.inner_dim)
        self.text_embedder = _MLP2(cfg.text_dim, cfg.inner_dim)
        if cfg.image_dim:
            self.image_embedder = WanImageEmbedding(cfg)

    def forward(self, timestep: torch.Tensor, text: torch.Tensor,
                image: Optional[torch.Tensor], dtype):
        """timestep [N] -> (temb [N, D], tproj [N, 6D], text [.., D], image [.., D] or None)."""
        t_sin = sinusoidal_timestep_embedding(timestep, self.freq_dim, flip_sin_to_cos=True,
                                              downscale_freq_shift=0.0)
        te = self.time_embedder
        temb = te.linear_2(silu(te.linear_1(t_sin.to(dtype))))
        tproj = self.time_proj(silu(temb))
        tx = self.text_embedder
        text_emb = tx.linear_2(gelu_tanh(tx.linear_1(text)))
        img_emb = None
        if image is not None and hasattr(self, "image_embedder"):
            img_emb = self.image_embedder(image)
        return temb, tproj, text_emb, img_emb


def patchify(patch_embedding: nn.Conv3d, video: torch.Tensor, patch) -> torch.Tensor:
    """Conv3d(k = stride = patch) as a linear over (C, pt, ph, pw)-ordered
    voxels: video [B, F, H, W, C] -> tokens [B, F/pt * H/ph * W/pw, D]."""
    b, f, h, w, c = video.shape
    pt, ph, pw = patch
    x = video.reshape(b, f // pt, pt, h // ph, ph, w // pw, pw, c)
    x = x.permute(0, 1, 3, 5, 7, 2, 4, 6)  # [B, F', h, w, C, pt, ph, pw]
    x = x.reshape(b, (f // pt) * (h // ph) * (w // pw), c * pt * ph * pw)
    return F.linear(x, stored(patch_embedding.weight, x.dtype).flatten(1),
                    stored(patch_embedding.bias, x.dtype))


def expand_patch_embedding(model: "WanTransformer3DMOTModel",
                           extra_in_channels: int) -> "WanTransformer3DMOTModel":
    """Widen ``patch_embedding`` in place to take ``extra_in_channels`` more
    input channels ([noisy ‖ control(+mask)], ``expand_patch_embedding``,
    ``vap_tpu/models/wan/transformer_mot.py:221``): the old channels keep
    their weights, the new ones start at zero, so the widened model starts
    as the one it was; the config's ``in_channels`` follows. Returns the
    model."""
    old = model.patch_embedding
    cfg = dataclasses.replace(model.config, in_channels=model.config.in_channels
                              + extra_in_channels)
    new = nn.Conv3d(cfg.in_channels, old.out_channels, cfg.patch_size, stride=cfg.patch_size,
                    device=old.weight.device, dtype=old.weight.dtype)
    with torch.no_grad():
        new.weight.zero_()
        new.weight[:, :old.in_channels] = old.weight
        new.bias.copy_(old.bias)
    new.requires_grad_(old.weight.requires_grad)
    model.patch_embedding = new
    model.config = cfg
    return model


def unpatchify(x: torch.Tensor, patch, ppf: int, pph: int, ppw: int) -> torch.Tensor:
    b = x.shape[0]
    pt, ph, pw = patch
    out = x.reshape(b, ppf, pph, ppw, pt, ph, pw, -1)
    out = out.permute(0, 1, 4, 2, 5, 3, 6, 7)  # [B, F', pt, h, ph, w, pw, C]
    return out.reshape(b, ppf * pt, pph * ph, ppw * pw, -1)


class WanTransformer3DMOTModel(nn.Module):
    """The Wan VAP transformer, or the plain one when no block has MoT.
    ``forward`` returns the target prediction [B, F, H, W, C_out],
    channel-last."""

    def __init__(self, cfg: WanMOTConfig):
        super().__init__()
        self.config = cfg
        dim = cfg.inner_dim
        self.patch_embedding = nn.Conv3d(cfg.in_channels, dim, cfg.patch_size, stride=cfg.patch_size)
        self.condition_embedder = WanConditionEmbedder(cfg)
        if cfg.block_idx_with_mot_ref:
            self.patch_embedding_mot_ref = nn.Conv3d(cfg.in_channels, dim, cfg.patch_size,
                                                     stride=cfg.patch_size)
            self.condition_embedder_mot_ref = WanConditionEmbedder(cfg)
        mot = set(cfg.block_idx_with_mot_ref)
        self.blocks = nn.ModuleList([WanBlock(cfg, i in mot) for i in range(cfg.num_layers)])
        self.proj_out = nn.Linear(dim, cfg.out_channels * int(np.prod(cfg.patch_size)))
        self.scale_shift_table = nn.Parameter(torch.zeros(1, 2, dim))
        if cfg.reference_train_mode == "reference_independent":
            self.proj_out_mot_ref = nn.Linear(dim, cfg.out_channels * int(np.prod(cfg.patch_size)))
            self.scale_shift_table_mot_ref = nn.Parameter(torch.zeros(1, 2, dim))

    def prologue(self, hidden_states, timestep, encoder_hidden_states,
                 encoder_hidden_states_image=None, hidden_states_mot_ref=None,
                 timestep_mot_ref=None, encoder_hidden_states_mot_ref=None,
                 encoder_hidden_states_image_mot_ref=None,
                 num_mot_ref: int = 1) -> Tuple[Tuple[torch.Tensor, Optional[torch.Tensor]], Dict]:
        """Embeddings, patchify and RoPE (``wan_prologue``, :471-515).
        Returns ((hs, hs_ref), aux): aux holds what every block reads;
        hs_ref is None without reference inputs (the trunk alone)."""
        cfg = self.config
        b, f, h, w, _ = hidden_states.shape
        pt, ph, pw = cfg.patch_size
        ppf, pph, ppw = f // pt, h // ph, w // pw
        dtype, dev = hidden_states.dtype, hidden_states.device
        r = num_mot_ref

        rope = wan_rope(cfg, ppf, pph, ppw, device=dev)
        hs = patchify(self.patch_embedding, hidden_states, cfg.patch_size)
        temb, tproj, ctx_text, ctx_img = self.condition_embedder(
            timestep, encoder_hidden_states, encoder_hidden_states_image, dtype)
        aux = {"ctx_text": ctx_text, "ctx_img": ctx_img, "tproj": tproj.reshape(b, 6, -1).float(),
               "rope": rope, "temb": temb, "grid": (ppf, pph, ppw), "dtype": dtype,
               "num_mot_ref": r}
        if hidden_states_mot_ref is None:
            return (hs, None), aux
        if not cfg.block_idx_with_mot_ref:
            raise ValueError("reference inputs given to a Wan transformer without MoT blocks")

        f_ref = hidden_states_mot_ref.shape[1]
        rope_ref = wan_rope(cfg, f_ref // pt, pph, ppw, negative_time=True, total_ref_frames=f_ref,
                            device=dev)
        # per-ref patchify keeps each reference's token block contiguous
        vid_ref = hidden_states_mot_ref.reshape(b * r, f_ref // r, h, w, -1)
        hs_ref = patchify(self.patch_embedding_mot_ref, vid_ref, cfg.patch_size).reshape(b, -1, cfg.inner_dim)
        temb_ref, tproj_ref, ctx_text_ref, ctx_img_ref = self.condition_embedder_mot_ref(
            timestep_mot_ref.reshape(-1), encoder_hidden_states_mot_ref,
            encoder_hidden_states_image_mot_ref, dtype)
        aux.update({"ctx_text_ref": ctx_text_ref, "ctx_img_ref": ctx_img_ref,
                    "tproj_ref": tproj_ref.reshape(b, r, 6, -1).float(), "rope_ref": rope_ref,
                    "temb_ref": temb_ref})
        return (hs, hs_ref), aux

    def run_blocks(self, carry, aux, remat: Union[bool, str] = False, start: int = 0,
                   stop: Optional[int] = None):
        """Blocks ``start`` to ``stop`` (all by default; ``wan_run_segment``
        over the segments) under ``remat`` (``remat_plan`` over each run
        of MoT or plain blocks, as JAX scans them)."""
        plan = segments_plan(remat, [length for _, length, _ in self.config.mot_segments])
        hs, hs_ref = carry
        stop = len(self.blocks) if stop is None else stop
        for i in range(start, stop):
            block, mode = self.blocks[i], plan[i]
            if hs_ref is None:
                hs, _ = run_block(block, mode, hs, aux["ctx_text"], aux["ctx_img"],
                                  aux["tproj"], aux["rope"])
            else:
                hs, hs_ref = run_block(block, mode, hs, aux["ctx_text"], aux["ctx_img"],
                                       aux["tproj"], aux["rope"], hs_ref, aux["ctx_text_ref"],
                                       aux["ctx_img_ref"], aux["tproj_ref"], aux["rope_ref"],
                                       aux["num_mot_ref"])
        return hs, hs_ref

    def epilogue(self, carry, aux, reference_head: bool = True
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Final AdaLN, projection and unpatchify (``wan_epilogue``,
        :543-573). Returns (the prediction, the reference stream's under
        ``reference_independent`` with references and ``reference_head``,
        else None)."""
        cfg = self.config
        hs, hs_ref = carry
        st = self.scale_shift_table.float() + aux["temb"].float()[:, None]
        shift, scale = st[:, 0][:, None], st[:, 1][:, None]
        hs = (layer_norm(hs.float(), None, None, cfg.eps) * (1 + scale) + shift).to(aux["dtype"])
        out = unpatchify(self.proj_out(hs), cfg.patch_size, *aux["grid"])
        if (hs_ref is None or not reference_head
                or cfg.reference_train_mode != "reference_independent"):
            return out, None
        b, r, s_ref = hs.shape[0], aux["num_mot_ref"], hs_ref.shape[1]
        st = (self.scale_shift_table_mot_ref.float() + aux["temb_ref"].float()[:, None])
        st = st.reshape(b, r, 2, -1)
        shift, scale = st[:, :, 0][:, :, None], st[:, :, 1][:, :, None]
        nref = layer_norm(hs_ref.float(), None, None, cfg.eps).reshape(b, r, s_ref // r, -1)
        nref = (nref * (1 + scale) + shift).reshape(b, s_ref, -1).to(aux["dtype"])
        _, pph, ppw = aux["grid"]
        return out, unpatchify(self.proj_out_mot_ref(nref), cfg.patch_size,
                               s_ref // (pph * ppw), pph, ppw)

    def forward(self, hidden_states: torch.Tensor, timestep: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                encoder_hidden_states_image: Optional[torch.Tensor] = None,
                hidden_states_mot_ref: Optional[torch.Tensor] = None,
                timestep_mot_ref: Optional[torch.Tensor] = None,
                encoder_hidden_states_mot_ref: Optional[torch.Tensor] = None,
                encoder_hidden_states_image_mot_ref: Optional[torch.Tensor] = None,
                num_mot_ref: int = 1, remat: Union[bool, str] = False) -> torch.Tensor:
        """hidden_states [B, F, H, W, C_in]; timestep [B]; text [B, L, D_text];
        image [B, 257, D_img] or None (T2V); refs [B, R*F, H, W, C_in],
        timestep_mot_ref [B, R], [B, R*L, D_text] and [B, R*257, D_img]
        (``wan_mot_forward``), or no reference at all (``wan_forward``).
        ``remat``: False, True / "full", "ops" or "block_skip:N"
        (``remat_plan``). The
        reference head's output of ``reference_independent`` is the second
        item of ``epilogue``'s result."""
        carry, aux = self.prologue(hidden_states, timestep, encoder_hidden_states,
                                   encoder_hidden_states_image, hidden_states_mot_ref,
                                   timestep_mot_ref, encoder_hidden_states_mot_ref,
                                   encoder_hidden_states_image_mot_ref, num_mot_ref)
        return self.epilogue(self.run_blocks(carry, aux, remat), aux, reference_head=False)[0]
