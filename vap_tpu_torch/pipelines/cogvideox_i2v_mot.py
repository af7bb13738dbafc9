"""CogVideoX image-to-video Video-As-Prompt pipeline in PyTorch.

Port of ``vap_tpu/pipelines/cogvideox_i2v_mot.py:51-631`` (the main path):
T5-encode the target and per-reference prompts with their CFG negatives;
VAE-encode the image, the reference videos (clean) and the reference first
frames; build the target and reference RoPE tables; run the DDIM denoise
with dynamic CFG, the CFG pair folded into the batch, as a Python loop over
steps; drop the pad frames, unscale and decode.

Not ported yet (they raise ``NotImplementedError``): the step cache, the DPM
scheduler, ``ablation_single_branch``, ``baseline_single_condition``, the
plain no-reference mode, temporal patching (``patch_size_t``) and offload.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.cogvideox.transformer_mot import CogVideoXTransformer3DMOTModel
from ..models.cogvideox.vae import (AutoencoderKLCogVideoX, posterior_mode, vae_decode_wsplit,
                                    vae_encode)
from ..models.text_encoders.t5 import T5EncoderModel
from ..ops.rope import prepare_cogvideox_rotary_embeddings
from ..ops.schedulers import CogVideoXDDIMScheduler

DEFAULT_NEGATIVE_PROMPT = (
    "Bright tones, overexposed, static, blurred details, subtitles, style, works, paintings, "
    "images, static, overall gray, worst quality, low quality, JPEG compression residue, ugly, "
    "incomplete, extra fingers, poorly drawn hands, poorly drawn faces, deformed, disfigured, "
    "misshapen limbs, fused fingers, still picture, messy background, three legs, many people "
    "in the background, walking backwards"
)


def select_frames(frames: Sequence, num: int, mode: str = "evenly") -> List:
    """Frame selection first/evenly/random (``cogvideox_i2v_mot.py:51-65``)."""
    if mode == "first":
        return list(frames[:num])
    if mode == "evenly":
        idx = np.linspace(0, len(frames) - 1, num).astype(np.int64)
        return [frames[i] for i in idx]
    if mode == "random":
        import random

        if len(frames) <= num:
            return list(frames)
        start = random.randint(0, len(frames) - num)
        return list(frames[start:start + num])
    raise ValueError(mode)


# --- copied from vap_tpu/pipelines/cogvideox_i2v_mot.py:68-78 ----------------
def dynamic_cfg_schedule(timesteps: np.ndarray, guidance_scale: float,
                         num_inference_steps: int) -> np.ndarray:
    """Cosine dynamic CFG, one value per step.

    The reference plugs the RAW timestep (e.g. 999) into (steps - t)/steps,
    so the cosine argument is huge and its value depends on float64 libm
    behaviour: compute in float64 exactly as math.cos does; float32 diverges."""
    t64 = np.asarray(timesteps, np.float64)
    return (1.0 + guidance_scale * (
        (1 - np.cos(np.pi * ((num_inference_steps - t64) / num_inference_steps) ** 5.0)) / 2
    )).astype(np.float32)


def resolve_device(device) -> torch.device:
    """The pipelines and the trainer run on the card unless the caller asks
    for the CPU; without a card, a CUDA device raises instead of running on
    the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this runs on the card; "
                           "pass device 'cpu' to run it on the CPU")
    return device


def decode_splits(lat_w: int) -> int:
    """W tiles for the decode, the JAX default (``cogvideox_i2v_mot.py:102``)."""
    return 2 if lat_w >= 80 else 1


@dataclasses.dataclass
class CogVideoXVAPPipeline:
    transformer: CogVideoXTransformer3DMOTModel
    vae: AutoencoderKLCogVideoX
    text_encoder: T5EncoderModel
    tokenizer: Any = None
    scheduler: Any = dataclasses.field(default_factory=CogVideoXDDIMScheduler)
    dtype: torch.dtype = torch.bfloat16
    # the card unless the caller asks for the CPU; raises where there is no card
    device: torch.device = torch.device("cuda")

    vae_scale_factor_spatial: int = 8
    vae_scale_factor_temporal: int = 4

    # host-clock seconds of the last call, per stage (each read after a
    # device synchronise, so they include the device time)
    stage_seconds: Dict[str, Any] = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    # conditioning
    # ------------------------------------------------------------------
    def encode_prompt_tokens(self, prompt: str, max_length: int = 226) -> np.ndarray:
        toks = self.tokenizer([prompt], padding="max_length", max_length=max_length,
                              truncation=True, add_special_tokens=True, return_tensors="np")
        return toks["input_ids"]

    def _t5_forward(self, input_ids: np.ndarray) -> torch.Tensor:
        # no attention mask, all positions kept (the reference's _get_t5_prompt_embeds)
        ids = torch.from_numpy(np.asarray(input_ids, np.int64)).to(self.device)
        return self.text_encoder(ids).to(self.dtype)

    def encode_prompt(self, prompt: str, negative_prompt: str,
                      max_length: int = 226) -> Tuple[torch.Tensor, torch.Tensor]:
        return (self._t5_forward(self.encode_prompt_tokens(prompt, max_length)),
                self._t5_forward(self.encode_prompt_tokens(negative_prompt, max_length)))

    def _vae_encode_mode(self, video: torch.Tensor, image_cond: bool = False) -> torch.Tensor:
        """Posterior mode, scaled — except image-conditioning latents under
        ``invert_scale_latents`` (CogVideoX 1.5 was trained without that
        multiply; ``cogvideox_i2v_mot.py:86-94``)."""
        z = posterior_mode(vae_encode(self.vae, video.to(self.dtype)))
        cfg = self.vae.config
        return z if (image_cond and cfg.invert_scale_latents) else z * cfg.scaling_factor

    def _rope(self, height, width, num_latent_frames, mot_num=0, ref_type="continous_negative"):
        cfg = self.transformer.config
        return prepare_cogvideox_rotary_embeddings(
            height, width, num_latent_frames, attention_head_dim=cfg.attention_head_dim,
            patch_size=cfg.patch_size, sample_width=cfg.sample_width,
            sample_height=cfg.sample_height, vae_scale_factor_spatial=self.vae_scale_factor_spatial,
            mot_num=mot_num, ref_type=ref_type, device=self.device)

    # ------------------------------------------------------------------
    # full generation
    # ------------------------------------------------------------------
    @torch.inference_mode()
    def __call__(
        self,
        image: np.ndarray,                       # [H, W, 3] float in [-1, 1]
        prompt: str = None,
        ref_videos: Optional[List[np.ndarray]] = None,  # list of [F, H, W, 3] in [-1, 1]
        prompt_mot_ref: Optional[List[str]] = None,
        negative_prompt: str = DEFAULT_NEGATIVE_PROMPT,
        negative_prompt_mot_ref: str = DEFAULT_NEGATIVE_PROMPT,
        height: int = 480,
        width: int = 720,
        num_frames: int = 49,
        num_inference_steps: int = 50,
        guidance_scale: float = 6.0,
        use_dynamic_cfg: bool = True,
        seed: int = 42,
        ref_type: str = "continous_negative",
        max_sequence_length: int = 226,
        prompt_embeds: Optional[torch.Tensor] = None,
        negative_prompt_embeds: Optional[torch.Tensor] = None,
        prompt_embeds_mot_ref: Optional[torch.Tensor] = None,
        negative_prompt_embeds_mot_ref: Optional[torch.Tensor] = None,
        latents: Optional[torch.Tensor] = None,
        output_type: str = "np",
        ablation_single_branch: bool = False,
        baseline_single_condition: bool = False,
        step_cache: Optional[str] = None,
    ):
        unported = {
            "ablation_single_branch": ablation_single_branch,
            "baseline_single_condition": baseline_single_condition,
            "step_cache": step_cache is not None,
            "plain mode (no reference videos)": not ref_videos and prompt_embeds_mot_ref is None,
            "image=None (text-to-video)": image is None,
            "a scheduler other than DDIM": not isinstance(self.scheduler, CogVideoXDDIMScheduler),
        }
        bad = [name for name, on in unported.items() if on]
        if bad:
            raise NotImplementedError(f"not ported to PyTorch yet: {bad}")
        times = self.stage_seconds
        times.clear()
        dev, dtype = self.device, self.dtype
        do_cfg = guidance_scale > 1.0
        self._sync()
        t0 = time.perf_counter()

        # 1. prompts
        if prompt_embeds is None:
            prompt_embeds, negative_prompt_embeds = self.encode_prompt(
                prompt, negative_prompt, max_sequence_length)
        embeds = torch.cat([negative_prompt_embeds, prompt_embeds]) if do_cfg else prompt_embeds
        if prompt_embeds_mot_ref is None:
            pairs = [self.encode_prompt(p, negative_prompt_mot_ref, max_sequence_length)
                     for p in prompt_mot_ref]
            prompt_embeds_mot_ref = torch.cat([pe for pe, _ in pairs], dim=1)
            negative_prompt_embeds_mot_ref = torch.cat([ne for _, ne in pairs], dim=1)
        embeds_ref = (torch.cat([negative_prompt_embeds_mot_ref, prompt_embeds_mot_ref])
                      if do_cfg else prompt_embeds_mot_ref)
        self._sync()
        times["text_encode"] = time.perf_counter() - t0

        # 2. conditioning latents (channel-last [1, F, h, w, C])
        t0 = time.perf_counter()
        num_latent_frames = (num_frames - 1) // self.vae_scale_factor_temporal + 1
        lat_h = height // self.vae_scale_factor_spatial
        lat_w = width // self.vae_scale_factor_spatial
        latent_channels = self.transformer.config.in_channels // 2

        def pad_frames(z):
            pad = z.new_zeros((1, num_latent_frames - 1, lat_h, lat_w, latent_channels))
            return torch.cat([z, pad], dim=1)

        img = torch.as_tensor(np.asarray(image, np.float32), device=dev)[None, None]
        image_latents = pad_frames(self._vae_encode_mode(img, image_cond=True))
        ref_lat_list, ref_img_lat_list = [], []
        for rv in ref_videos:
            rv_t = torch.as_tensor(np.asarray(rv, np.float32), device=dev)[None]
            ref_lat_list.append(self._vae_encode_mode(rv_t))
            ref_img_lat_list.append(pad_frames(self._vae_encode_mode(rv_t[:, :1], image_cond=True)))
        ref_latents = torch.cat(ref_lat_list, dim=1)
        ref_image_latents = torch.cat(ref_img_lat_list, dim=1)
        num_mot_ref = ref_latents.shape[1] // num_latent_frames

        if latents is None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            latents = torch.randn((1, num_latent_frames, latent_channels, lat_h, lat_w),
                                  generator=gen, device=dev, dtype=torch.float32)
        latents = torch.as_tensor(latents, dtype=torch.float32, device=dev)
        latents = latents * self.scheduler.init_noise_sigma

        # channel-last -> transformer layout [B, F, C, H, W]
        def to_fchw(x):
            return x.permute(0, 1, 4, 2, 3).to(dtype)

        mult = 2 if do_cfg else 1
        image_in = to_fchw(image_latents).repeat(mult, 1, 1, 1, 1)
        ref_in = torch.cat([to_fchw(ref_latents), to_fchw(ref_image_latents)],
                           dim=2).repeat(mult, 1, 1, 1, 1)
        self._sync()
        times["vae_encode"] = time.perf_counter() - t0

        # 3. RoPE tables and per-step scalars
        rope = self._rope(height, width, num_latent_frames)
        rope_ref = self._rope(height, width, num_latent_frames, num_mot_ref, ref_type)
        ts = self.scheduler.timesteps(num_inference_steps).astype(np.float32)
        coeffs = [torch.from_numpy(c).to(dev) for c in
                  self.scheduler.step_coefficients(num_inference_steps)]
        guidance = (dynamic_cfg_schedule(ts, guidance_scale, num_inference_steps)
                    if use_dynamic_cfg else np.full_like(ts, guidance_scale))

        # 4. denoise
        step_times = []
        for i, t in enumerate(ts):
            t0 = time.perf_counter()
            latent_in = torch.cat([latents.to(dtype).repeat(mult, 1, 1, 1, 1), image_in], dim=2)
            timestep = torch.full((mult,), float(t), dtype=torch.float32, device=dev)
            noise_pred = self.transformer(
                hidden_states=latent_in, encoder_hidden_states=embeds, timestep=timestep,
                image_rotary_emb=rope, hidden_states_mot_ref=ref_in,
                encoder_hidden_states_mot_ref=embeds_ref, image_rotary_emb_mot_ref=rope_ref,
                num_mot_ref=num_mot_ref).float()
            if do_cfg:
                uncond, cond = noise_pred.chunk(2)
                noise_pred = uncond + float(guidance[i]) * (cond - uncond)
            latents = self.scheduler.step(noise_pred, latents, coeffs[0][i], coeffs[1][i],
                                          coeffs[2][i])
            self._sync()
            step_times.append(time.perf_counter() - t0)
        times["denoise_steps"] = step_times

        if output_type == "latent":
            return latents

        # 5. decode: channel-last, unscaled (the decode division keeps the
        # factor even under invert_scale_latents)
        t0 = time.perf_counter()
        z = latents.permute(0, 1, 3, 4, 2).to(dtype) / self.vae.config.scaling_factor
        video = vae_decode_wsplit(self.vae, z, decode_splits(z.shape[3]))
        out = video.float().cpu().numpy()
        times["vae_decode"] = time.perf_counter() - t0
        return out
