"""Wan2.1 image-to-video Video-As-Prompt pipeline in PyTorch.

Port of ``vap_tpu/pipelines/wan_i2v_mot.py:83-514``: UMT5-encode the
prompts, zeroed past each prompt's length; CLIP-encode the target image and
each reference's first frame; Wan-VAE encode the conditioning video, the
reference video and the reference conditioning video into the 36-channel
inputs [noisy(16) ‖ mask(4) ‖ cond-latent(16)]; run the denoise, FlowMatch
Euler or UniPC, with CFG folded into the batch, as a Python loop over
steps, with the optional step cache (``pipelines/step_cache.py``); decode
the latents one latent frame at a time (``enable_vae_tiling``: the
overlap-blended tile grid; ``enable_vae_slicing``: one batch element at a
time).

Without reference videos (plain) the trunk runs alone, a crush_smol-style
finetune; a text-to-video checkpoint (``in_channels == z_dim``) takes no
conditioning channels, and a model without ``image_dim`` no CLIP context.
With ``enable_model_offload`` every component stays in host memory and one
at a time is staged onto the card (``pipelines/offload.py``);
``offload_blocks_chunk`` streams the transformer's blocks through the card
that many at a time (``pipelines/streamed.py``), with the same step cache
and scheduler steps.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..data.video import resize_frame
from ..models.text_encoders.clip_vision import CLIPVisionModel
from ..models.text_encoders.t5 import T5EncoderModel
from ..models.wan.transformer_mot import WanTransformer3DMOTModel
from ..models.wan.vae import (AutoencoderKLWan, denormalize_latents, normalize_latents,
                              wan_vae_decode_streamed, wan_vae_decode_tiled, wan_vae_encode)
from ..ops.schedulers import FlowMatchEulerScheduler, UniPCScheduler
from .cogvideox_i2v_mot import DEFAULT_NEGATIVE_PROMPT, resolve_device
from .offload import StagedComponents
from .step_cache import StepCacheSchedule, parse_step_cache
from .streamed import PinnedBlocks, StreamedTransformer

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


# --- copied from vap_tpu/pipelines/wan_i2v_mot.py:83-92 (make_i2v_mask) ------
def make_i2v_mask(batch: int, num_frames: int, lat_h: int, lat_w: int,
                  temporal_ratio: int = 4) -> np.ndarray:
    """First-frame mask, 4 channels per latent frame (reference pipeline
    :807-817). Returns [B, F_lat, lat_h, lat_w, 4] channel-last."""
    mask = np.ones((batch, 1, num_frames, lat_h, lat_w), np.float32)
    mask[:, :, 1:] = 0
    first = np.repeat(mask[:, :, :1], temporal_ratio, axis=2)
    mask = np.concatenate([first, mask[:, :, 1:]], axis=2)
    mask = mask.reshape(batch, -1, temporal_ratio, lat_h, lat_w).transpose(0, 2, 1, 3, 4)
    return mask.transpose(0, 2, 3, 4, 1)


@dataclasses.dataclass
class WanVAPPipeline(StagedComponents):
    COMPONENTS = ("transformer", "vae", "text_encoder", "image_encoder")
    BLOCKS = "blocks"

    transformer: WanTransformer3DMOTModel
    vae: AutoencoderKLWan
    text_encoder: T5EncoderModel
    image_encoder: CLIPVisionModel
    tokenizer: Any = None
    scheduler: Any = dataclasses.field(default_factory=lambda: FlowMatchEulerScheduler(shift=3.0))
    dtype: torch.dtype = torch.bfloat16
    # the card unless the caller asks for the CPU; raises where there is no card
    device: torch.device = torch.device("cuda")

    vae_scale_factor_spatial: int = 8
    vae_scale_factor_temporal: int = 4

    # weights on the host, one component at a time staged onto the device
    enable_model_offload: bool = False
    # decode memory (the reference's enable_tiling / enable_slicing); slicing
    # is kept for parity with JAX: ``__call__`` decodes a batch of 1, so it
    # changes nothing there
    enable_vae_tiling: bool = False
    enable_vae_slicing: bool = False
    # streamed block offload: the blocks in host memory, this many at a time
    # on the device (the weights must be in host memory)
    offload_blocks_chunk: Optional[int] = None

    # host-clock seconds of the last call, per stage, each read after a
    # device synchronise; "staging" holds the host->device copies of offload
    stage_seconds: Dict[str, Any] = dataclasses.field(default_factory=dict, repr=False)
    _staged: list = dataclasses.field(default_factory=list, repr=False)
    _pinned: Optional[PinnedBlocks] = dataclasses.field(default=None, repr=False)
    _streamed: Optional[StreamedTransformer] = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def _decode(self, z: torch.Tensor) -> torch.Tensor:
        if self.enable_vae_slicing and z.shape[0] > 1:
            return torch.cat([self._decode_one(z[i:i + 1]) for i in range(z.shape[0])])
        return self._decode_one(z)

    def _decode_one(self, z: torch.Tensor) -> torch.Tensor:
        vae = self._component("vae")
        z = denormalize_latents(vae.config, z)
        if self.enable_vae_tiling:
            return wan_vae_decode_tiled(vae, z)
        return wan_vae_decode_streamed(vae, z)

    # ------------------------------------------------------------------
    # conditioning
    # ------------------------------------------------------------------
    def encode_prompt(self, prompt: str, max_length: int = 512) -> torch.Tensor:
        """UMT5 embeddings [1, L, D], zeroed past the prompt's length."""
        toks = self.tokenizer([prompt], padding="max_length", max_length=max_length,
                              truncation=True, add_special_tokens=True, return_tensors="np")
        ids = torch.from_numpy(np.asarray(toks["input_ids"], np.int64)).to(self.device)
        mask = torch.from_numpy(np.asarray(toks["attention_mask"], np.int64)).to(self.device)
        out = self._component("text_encoder")(ids, mask)
        return (out * mask[..., None].to(out.dtype)).to(self.dtype)

    def clip_preprocess(self, image: np.ndarray) -> torch.Tensor:
        """[H, W, 3] in [-1, 1] -> [1, S, S, 3] float32, resized to the CLIP
        size and CLIP-normalised (host side)."""
        img01 = (np.asarray(image, np.float32) + 1.0) / 2.0
        size = self.image_encoder.config.image_size
        img = resize_frame(img01, size, size)
        return torch.from_numpy((img - CLIP_MEAN) / CLIP_STD)[None]

    def encode_image(self, image: np.ndarray) -> torch.Tensor:
        """[H, W, 3] in [-1, 1] -> CLIP penultimate hidden state [1, 257, D]."""
        px = self.clip_preprocess(image).to(self.device)
        return self._component("image_encoder")(px).to(self.dtype)

    def _vae_encode(self, video: torch.Tensor) -> torch.Tensor:
        """Posterior mean (sample_mode "argmax"), normalised; channel-last."""
        vae = self._component("vae")
        mean = wan_vae_encode(vae, video.to(self.dtype))[..., :vae.config.z_dim]
        return normalize_latents(vae.config, mean)

    # ------------------------------------------------------------------
    # full generation
    # ------------------------------------------------------------------
    @torch.inference_mode()
    def __call__(
        self,
        image: Optional[np.ndarray],             # [H, W, 3] in [-1, 1]; unused by T2V
        prompt: str = None,
        ref_videos: Optional[List[np.ndarray]] = None,   # list of [F, H, W, 3] in [-1, 1]
        prompt_mot_ref: Optional[List[str]] = None,
        negative_prompt: str = DEFAULT_NEGATIVE_PROMPT,
        negative_prompt_mot_ref: str = DEFAULT_NEGATIVE_PROMPT,
        height: int = 480,
        width: int = 832,
        num_frames: int = 49,
        num_inference_steps: int = 50,
        guidance_scale: float = 5.0,
        seed: int = 42,
        max_sequence_length: int = 512,
        latents: Optional[torch.Tensor] = None,
        output_type: str = "np",
        step_cache: Optional[str] = None,
    ):
        use_unipc = isinstance(self.scheduler, UniPCScheduler)
        if not use_unipc and not isinstance(self.scheduler, FlowMatchEulerScheduler):
            raise ValueError(f"unknown scheduler {type(self.scheduler).__name__}; "
                             "FlowMatchEulerScheduler or UniPCScheduler")
        schedule = StepCacheSchedule(parse_step_cache(step_cache, num_inference_steps))
        tcfg = self.transformer.config
        # plain (no reference videos): the trunk alone; a T2V checkpoint
        # (in_channels == z_dim) takes no conditioning channels
        plain = not ref_videos
        t2v = plain and tcfg.in_channels == self.vae.config.z_dim
        use_clip = not t2v and tcfg.image_dim is not None
        times = self.stage_seconds
        times.clear()
        dev, dtype = self.device, self.dtype
        do_cfg = guidance_scale > 1.0
        mult = 2 if do_cfg else 1
        r = 1 if plain else len(ref_videos)

        # 1. prompts (UMT5)
        self._component("text_encoder")
        t0 = time.perf_counter()
        pe = self.encode_prompt(prompt, max_sequence_length)
        embeds = (torch.cat([self.encode_prompt(negative_prompt, max_sequence_length), pe])
                  if do_cfg else pe)
        embeds_ref = None
        if not plain:
            pe_ref = torch.cat([self.encode_prompt(p, max_sequence_length)
                                for p in prompt_mot_ref], dim=1)
            ne_ref = torch.cat([self.encode_prompt(negative_prompt_mot_ref,
                                                   max_sequence_length)] * r, dim=1)
            embeds_ref = torch.cat([ne_ref, pe_ref]) if do_cfg else pe_ref
        self._sync()
        times["text_encode"] = time.perf_counter() - t0

        # 2. CLIP image embeddings of the target and of each reference's first frame
        img_embeds = img_embeds_ref = None
        if use_clip:
            self._component("image_encoder")
            t0 = time.perf_counter()
            img_embeds = torch.cat([self.encode_image(image)] * mult)
            if not plain:
                img_embeds_ref = torch.cat(
                    [torch.cat([self.encode_image(rv[0]) for rv in ref_videos], dim=1)] * mult)
            self._sync()
            times["image_encode"] = time.perf_counter() - t0

        # 3. VAE latents and the 36-channel conditioning (channel-last)
        f_lat = (num_frames - 1) // self.vae_scale_factor_temporal + 1
        lat_h = height // self.vae_scale_factor_spatial
        lat_w = width // self.vae_scale_factor_spatial
        cond_in = ref_in = None
        if not t2v:
            self._component("vae")
            t0 = time.perf_counter()

            def first_frame_video(frame) -> torch.Tensor:
                first = torch.as_tensor(np.asarray(frame, np.float32), device=dev)[None, None]
                return torch.cat([first, first.new_zeros((1, num_frames - 1, height, width, 3))],
                                 dim=1)

            mask = torch.from_numpy(make_i2v_mask(1, num_frames, lat_h, lat_w,
                                                  self.vae_scale_factor_temporal)).to(dev)
            cond_latent = self._vae_encode(first_frame_video(image))
            condition = torch.cat([mask.to(cond_latent.dtype), cond_latent], dim=-1)  # [1, F, h, w, 20]
            cond_in = condition.to(dtype).repeat(mult, 1, 1, 1, 1)
            if not plain:
                ref_lat, ref_cond = [], []
                for rv in ref_videos:
                    ref_lat.append(self._vae_encode(
                        torch.as_tensor(np.asarray(rv, np.float32), device=dev)[None]))
                    cl = self._vae_encode(first_frame_video(rv[0]))
                    ref_cond.append(torch.cat([mask.to(cl.dtype), cl], dim=-1))
                ref_input = torch.cat([torch.cat(ref_lat, dim=1), torch.cat(ref_cond, dim=1)],
                                      dim=-1)
                ref_in = ref_input.to(dtype).repeat(mult, 1, 1, 1, 1)
            self._sync()
            times["vae_encode"] = time.perf_counter() - t0

        if latents is None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            latents = torch.randn((1, f_lat, lat_h, lat_w, self.vae.config.z_dim), generator=gen,
                                  device=dev)
        latents = torch.as_tensor(latents, dtype=torch.float32, device=dev)

        # 4. denoise, the CFG pair folded into the batch. The step cache keeps
        # the raw CFG-batch prediction and reuses it on skipped steps; every
        # step recombines CFG and advances the scheduler (:245-305)
        streamed = bool(self.offload_blocks_chunk)
        if streamed:
            transformer = self.streamed_runner()
        else:
            self.close_streamed()  # a streamed call may have locked the blocks' pages
            transformer = self._component("transformer")
        ts = self.scheduler.timesteps(num_inference_steps).astype(np.float32)
        if use_unipc:
            coeffs = self.scheduler.step_coefficients(num_inference_steps)
            carry = self.scheduler.init_carry(latents)
        else:
            sigmas = self.scheduler.sigmas(num_inference_steps)
        t_ref = torch.ones((mult, r), dtype=torch.float32, device=dev)

        def raw_pred(latents, t):
            """One CFG-batch forward -> f32 [mult, F, h, w, C] (:545-571)."""
            x_in = latents.to(dtype).repeat(mult, 1, 1, 1, 1)
            if not t2v:
                x_in = torch.cat([x_in, cond_in], dim=-1)
            timestep = torch.full((mult,), float(t), dtype=torch.float32, device=dev)
            if plain:
                return transformer(hidden_states=x_in, timestep=timestep,
                                   encoder_hidden_states=embeds,
                                   encoder_hidden_states_image=img_embeds).float()
            return transformer(
                hidden_states=x_in, timestep=timestep, encoder_hidden_states=embeds,
                encoder_hidden_states_image=img_embeds, hidden_states_mot_ref=ref_in,
                timestep_mot_ref=t_ref, encoder_hidden_states_mot_ref=embeds_ref,
                encoder_hidden_states_image_mot_ref=img_embeds_ref, num_mot_ref=r).float()

        step_times, computed = [], []
        cached = None
        try:
            for i, t in enumerate(ts):
                t0 = time.perf_counter()
                if schedule.compute(i, latents):
                    cached = raw_pred(latents, t)
                    computed.append(i)
                pred = cached
                if do_cfg:
                    uncond, cond = pred.chunk(2)
                    pred = uncond + float(guidance_scale) * (cond - uncond)
                if use_unipc:
                    latents, carry = self.scheduler.step(pred, latents, carry,
                                                         {k: v[i] for k, v in coeffs.items()})
                else:
                    latents = self.scheduler.step(pred, latents, sigmas[i], sigmas[i + 1])
                self._sync()
                step_times.append(time.perf_counter() - t0)
        finally:
            if streamed:
                transformer.release()
        times["denoise_steps"] = step_times
        times["computed_steps"] = computed

        if output_type == "latent":
            return latents

        # 5. decode
        self._component("vae")
        t0 = time.perf_counter()
        out = self._decode(latents.to(dtype)).float().cpu().numpy()
        times["vae_decode"] = time.perf_counter() - t0
        return out
