"""The model specs of the trainer: each family's encoders, the MoT expert
cloned from a stock checkpoint.

Port of ``vap_tpu/training/specs.py:25-165`` (``expected_mot_ref_shapes``,
``_xavier_uniform``, ``build_mot_state_dict_from_base``,
``build_wan_mot_state_dict_from_base``). The state dicts are mappings of
diffusers keys to tensors (a ``SafetensorsDict`` of a stock CogVideoX or
Wan checkpoint, typically): a clone is the same tensor under the
``_mot_ref`` name, no copy. Fresh weights (a base-vs-target shape mismatch
under a custom structure) and the zero effect / reference embeddings are
drawn with numpy's ``default_rng(seed)`` in JAX's order, so they equal
JAX's to the bit.

The specs (``CogVideoXSpec`` :168, ``WanSpec`` :576, ``HunyuanVideoSpec``
:304) hold the trained transformer, the text encoder(s), the VAE, the image
encoder and the tokenizer(s) as modules and callables, on one device:
``prepare_conditions`` and ``prepare_latents`` encode a bucket-fitted sample
(float32 [-1, 1] [F, H, W, 3] videos) into the precomputed cache's arrays,
float32, in JAX's layouts (``data/precomputation.py``); ``validation``
samples the family's pipeline with the live transformer (``_cogvideox_validation``
:274, ``_wan_validation`` :672, ``_hunyuan_validation`` :771), a video
[F, H, W, 3] in [-1, 1]. The encoders are frozen and run without autograd.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..data.video import normalize_video, read_image, resize_video
from ..models.cogvideox.config import CogVideoXMOTConfig
from ..models.hunyuan_video.vae import prepare_latents as hunyuan_prepare_latents
from ..pipelines.cogvideox_i2v_mot import CogVideoXVAPPipeline
from ..pipelines.hunyuan_video import HunyuanVideoPipeline
from ..pipelines.wan_i2v_mot import WanVAPPipeline, make_i2v_mask

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


# ---------------------------------------------------------------------------
# the specs
# ---------------------------------------------------------------------------

def _validation_image(sample: Dict[str, Any], height: int, width: int) -> Optional[np.ndarray]:
    """A validation row's conditioning image: "image" (an array), else
    "image_path" (a file, resized to height x width), else None (T2V)."""
    if sample.get("image") is not None:
        return sample["image"]
    path = sample.get("image_path")
    if not path:
        return None
    img = read_image(path)[None].astype(np.float32) / 255.0
    return normalize_video(resize_video(img, height, width))[0]


def _numpy(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().cpu().numpy()


class _Spec:
    """What the three specs share: the modules, frozen, on ``device``."""

    family = ""
    ENCODERS: tuple = ()

    def __init__(self, transformer: nn.Module, tokenizer=None, dtype: torch.dtype = torch.bfloat16,
                 device=None, **encoders: Optional[nn.Module]):
        self.transformer = transformer
        self.tokenizer = tokenizer
        self.dtype = dtype
        self.device = torch.device(device) if device is not None else \
            next(transformer.parameters()).device
        for name in self.ENCODERS:
            module = encoders.get(name)
            if module is not None:
                module.requires_grad_(False).eval()
            setattr(self, name, module)

    @property
    def transformer_cfg(self):
        return self.transformer.config

    def encoders(self) -> Dict[str, nn.Module]:
        """The encoder modules present, by name (what the trainer offloads)."""
        return {n: getattr(self, n) for n in self.ENCODERS if getattr(self, n) is not None}

    def _video(self, video: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(video, np.float32), device=self.device)[None]


class CogVideoXSpec(_Spec):
    """CogVideoX VAP: T5 conditions, VAE latents [B, F, C, h, w] scaled."""

    family = "cogvideox"
    ENCODERS = ("vae", "text_encoder")

    def pipeline(self, **kw) -> CogVideoXVAPPipeline:
        return CogVideoXVAPPipeline(self.transformer, self.vae, self.text_encoder, self.tokenizer,
                                    dtype=self.dtype, device=self.device, **kw)

    @torch.no_grad()
    def prepare_conditions(self, sample: Dict[str, Any], max_length: int = 226) -> Dict[str, Any]:
        pipe = self.pipeline()

        def encode(text: str) -> np.ndarray:
            return _numpy(pipe._t5_forward(pipe.encode_prompt_tokens(text, max_length)))

        cond = {"encoder_hidden_states": encode(sample["caption"])}
        if sample.get("caption_mot_ref"):
            cond["encoder_hidden_states_mot_ref"] = np.concatenate(
                [encode(c) for c in sample["caption_mot_ref"]], axis=1)
        if self.transformer_cfg.supported_effect_types and sample.get("effect_types"):
            type_to_id = {t: i for i, t in enumerate(self.transformer_cfg.supported_effect_types)}
            cond["effect_ids"] = np.asarray([type_to_id[t] for t in sample["effect_types"]])
        return cond

    @torch.no_grad()
    def prepare_latents(self, sample: Dict[str, Any]) -> Dict[str, Any]:
        """The target, its first frame, each reference and its first frame,
        VAE-encoded (posterior mode, scaled) to [1, F, C, h, w]; the
        first-frame latents padded with zero frames to the target's."""
        pipe = self.pipeline()

        def enc(video: np.ndarray) -> np.ndarray:
            return np.ascontiguousarray(
                _numpy(pipe._vae_encode_mode(self._video(video))).transpose(0, 1, 4, 2, 3))

        video = sample["video"]
        latents = enc(video)
        f_lat = latents.shape[1]
        out = {"latents": latents}
        # a plain T2V finetune (in_channels == latent channels) takes no image latents
        if self.transformer_cfg.in_channels > latents.shape[2]:
            image_latent = enc(video[:1])
            pad = np.zeros((1, f_lat - 1) + image_latent.shape[2:], np.float32)
            out["image_latents"] = np.concatenate([image_latent, pad], axis=1)
        if not sample.get("ref_videos"):
            return out
        ref_lat, ref_img_lat = [], []
        for rv in sample["ref_videos"]:
            ref_lat.append(enc(rv))
            fi = enc(rv[:1])
            pad = np.zeros((1, f_lat - 1) + fi.shape[2:], np.float32)
            ref_img_lat.append(np.concatenate([fi, pad], axis=1))
        out["latents_mot_ref"] = np.concatenate(ref_lat, axis=1)
        out["image_latents_mot_ref"] = np.concatenate(ref_img_lat, axis=1)
        return out

    def validation(self, sample: Dict[str, Any], **gen_kwargs) -> np.ndarray:
        """One generation with the live transformer; a sample without
        reference videos runs the plain trunk. Returns [F, H, W, 3]."""
        defaults = dict(num_inference_steps=50, guidance_scale=6.0, use_dynamic_cfg=True,
                        max_sequence_length=self.transformer_cfg.max_text_seq_length)
        defaults.update(gen_kwargs)
        image = _validation_image(sample, defaults.get("height", 480), defaults.get("width", 720))
        video = self.pipeline()(image=image, prompt=sample["caption"],
                                ref_videos=sample.get("ref_videos"),
                                prompt_mot_ref=sample.get("caption_mot_ref"), **defaults)
        return video[0]


class WanSpec(_Spec):
    """Wan VAP: UMT5 conditions (zero past the prompt), CLIP image states,
    mean/std-normalised VAE latents channel-last, the 4-channel first-frame
    mask and the first frame's latents as ``condition``."""

    family = "wan"
    ENCODERS = ("vae", "text_encoder", "image_encoder")

    def pipeline(self, **kw) -> WanVAPPipeline:
        return WanVAPPipeline(self.transformer, self.vae, self.text_encoder, self.image_encoder,
                              self.tokenizer, dtype=self.dtype, device=self.device, **kw)

    @torch.no_grad()
    def prepare_conditions(self, sample: Dict[str, Any], max_length: int = 512) -> Dict[str, Any]:
        pipe = self.pipeline()

        def encode(text: str) -> np.ndarray:
            return _numpy(pipe.encode_prompt(text, max_length))

        cond = {"encoder_hidden_states": encode(sample["caption"])}
        if sample.get("caption_mot_ref"):
            cond["encoder_hidden_states_mot_ref"] = np.concatenate(
                [encode(c) for c in sample["caption_mot_ref"]], axis=1)
        if self.image_encoder is not None:
            cond["encoder_hidden_states_image"] = _numpy(pipe.encode_image(sample["video"][0]))
            if sample.get("ref_videos"):
                cond["encoder_hidden_states_image_mot_ref"] = np.concatenate(
                    [_numpy(pipe.encode_image(rv[0])) for rv in sample["ref_videos"]], axis=1)
        return cond

    @torch.no_grad()
    def prepare_latents(self, sample: Dict[str, Any]) -> Dict[str, Any]:
        pipe = self.pipeline()

        def enc(video: np.ndarray) -> np.ndarray:
            return _numpy(pipe._vae_encode(self._video(video)))

        def first_frame(video: np.ndarray) -> np.ndarray:
            return np.concatenate([video[:1], np.zeros((num_frames - 1, h, w, 3), np.float32)])

        video = sample["video"]
        num_frames, h, w = video.shape[:3]
        latents = enc(video)
        lh, lw = latents.shape[2:4]
        out = {"latents": latents}
        # a plain T2V finetune (in_channels == latent channels) takes no conditioning channels
        i2v = self.transformer_cfg.in_channels > latents.shape[-1]
        if i2v:
            mask = make_i2v_mask(1, num_frames, lh, lw).astype(np.float32)
            out["condition"] = np.concatenate([mask, enc(first_frame(video))], axis=-1)
        if not sample.get("ref_videos"):
            return out
        if not i2v:
            raise ValueError("VAP (MoT) samples need the I2V conditioning channels; the "
                             f"transformer config has in_channels={self.transformer_cfg.in_channels}")
        ref_lat, ref_cond = [], []
        for rv in sample["ref_videos"]:
            ref_lat.append(enc(rv))
            ref_cond.append(np.concatenate([mask, enc(first_frame(rv))], axis=-1))
        out["latents_mot_ref"] = np.concatenate(ref_lat, axis=1)
        out["condition_mot_ref"] = np.concatenate(ref_cond, axis=1)
        return out

    def validation(self, sample: Dict[str, Any], **gen_kwargs) -> np.ndarray:
        defaults = dict(num_inference_steps=50, guidance_scale=5.0,
                        max_sequence_length=self.transformer_cfg.text_len)
        gen_kwargs.pop("use_dynamic_cfg", None)  # CogVideoX's alone
        defaults.update(gen_kwargs)
        image = _validation_image(sample, defaults.get("height", 480), defaults.get("width", 832))
        video = self.pipeline()(image=image, prompt=sample["caption"],
                                ref_videos=sample.get("ref_videos"),
                                prompt_mot_ref=sample.get("caption_mot_ref"), **defaults)
        return video[0]


class HunyuanVideoSpec(_Spec):
    """HunyuanVideo: LLaMA hidden state -3 (the template's first 95 tokens
    cropped) with its mask, CLIP-L pooled; causal-VAE latents channel-first,
    scaled."""

    family = "hunyuan_video"
    ENCODERS = ("vae", "text_encoder", "text_encoder_2")

    def __init__(self, transformer: nn.Module, tokenizer=None, clip_tokenizer=None, **kw):
        super().__init__(transformer, tokenizer, **kw)
        self.clip_tokenizer = clip_tokenizer

    def pipeline(self, **kw) -> HunyuanVideoPipeline:
        return HunyuanVideoPipeline(self.transformer, self.vae, self.text_encoder,
                                    self.text_encoder_2, self.tokenizer, self.clip_tokenizer,
                                    dtype=self.dtype, device=self.device, **kw)

    @torch.no_grad()
    def prepare_conditions(self, sample: Dict[str, Any], max_length: int = 256) -> Dict[str, Any]:
        hidden, mask, pooled = self.pipeline().encode_prompt(sample["caption"], max_length)
        return {"encoder_hidden_states": _numpy(hidden), "prompt_attention_mask": _numpy(mask),
                "pooled_projections": _numpy(pooled)}

    @torch.no_grad()
    def prepare_latents(self, sample: Dict[str, Any]) -> Dict[str, Any]:
        return hunyuan_prepare_latents(self.vae, sample, self.dtype)

    def validation(self, sample: Dict[str, Any], **gen_kwargs) -> np.ndarray:
        defaults = dict(num_inference_steps=50, guidance_scale=6.0)
        for k in ("use_dynamic_cfg", "negative_prompt"):
            gen_kwargs.pop(k, None)
        defaults.update(gen_kwargs)
        return self.pipeline()(prompt=sample["caption"], **defaults)[0]


SPECS = {"cogvideox": CogVideoXSpec, "wan": WanSpec, "hunyuan_video": HunyuanVideoSpec}

# (model_name, training_type) -> spec (``SUPPORTED_MODEL_SPECS``, specs.py:239-243,
# :395-396, :700-703): the VAP families train every type, HunyuanVideo sft and lora
SUPPORTED_MODEL_SPECS = {
    **{(family, tt): SPECS[family] for family in ("cogvideox", "wan")
       for tt in ("video_as_prompt_mot", "sft", "lora", "dpo")},
    ("hunyuan_video", "sft"): HunyuanVideoSpec,
    ("hunyuan_video", "lora"): HunyuanVideoSpec,
}


def get_model_spec_cls(model_name: str, training_type: str):
    """The spec class of (model_name, training_type) (``get_model_spec_cls``,
    specs.py:246); an unsupported pair raises ValueError."""
    key = (model_name, training_type)
    if training_type.startswith("control"):
        from . import control_specs  # noqa: F401  (registers the control specs)
    if key not in SUPPORTED_MODEL_SPECS:
        raise ValueError(f"unsupported (model, training_type): {key}")
    return SUPPORTED_MODEL_SPECS[key]
