"""CogVideoX image-to-video Video-As-Prompt pipeline in PyTorch.

Port of ``vap_tpu/pipelines/cogvideox_i2v_mot.py:51-631``: T5-encode the
target and per-reference prompts with their CFG negatives; VAE-encode the
image, the reference videos (clean) and the reference first frames; build
the target and reference RoPE tables; run the denoise (DDIM or DPM, dynamic
CFG, the CFG pair folded into the batch) as a Python loop over steps, with
the optional step cache (``pipelines/step_cache.py``); unscale and decode
(the default width split, or with ``enable_vae_tiling`` the overlap-blended
tile grid; ``enable_vae_slicing`` decodes one batch element at a time).
W8A8 needs nothing here: it lives in the transformer's modules
(``models/common.py`` ``quantize_transformer_linears``).

Modes, derived as in JAX (:486-494): with reference videos the MoT call;
without (plain) the trunk alone, and with ``image=None`` too the
text-to-video model (``in_channels`` latent channels, no image latents);
``baseline_single_condition`` runs the trunk over the target only and
``ablation_single_branch`` over target ‖ references along frames, with the
two RoPE tables concatenated. ``enable_model_offload`` keeps the weights in
host memory and stages one component at a time (``pipelines/offload.py``).

Not ported (it raises ``NotImplementedError``): streamed block offload
(``offload_blocks_chunk``). Temporal patching (``patch_size_t``) raises
where the transformer is built.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.cogvideox.transformer_mot import CogVideoXTransformer3DMOTModel
from ..models.cogvideox.vae import (AutoencoderKLCogVideoX, posterior_mode, vae_decode_tiled,
                                    vae_decode_wsplit, vae_encode)
from ..models.text_encoders.t5 import T5EncoderModel
from ..ops.rope import prepare_cogvideox_rotary_embeddings
from ..ops.schedulers import CogVideoXDDIMScheduler, CogVideoXDPMScheduler
from .offload import StagedComponents
from .step_cache import StepCacheSchedule, parse_step_cache

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
class CogVideoXVAPPipeline(StagedComponents):
    COMPONENTS = ("transformer", "vae", "text_encoder")

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

    # decode memory (the reference's enable_tiling / enable_slicing): the
    # overlap-blended tile grid instead of the width split; one batch
    # element at a time (kept for parity with JAX: ``__call__`` decodes a
    # batch of 1, so slicing changes nothing there)
    enable_vae_tiling: bool = False
    enable_vae_slicing: bool = False
    # weights in host memory, one component at a time staged onto the device
    enable_model_offload: bool = False
    # streamed block offload: not ported, raises
    offload_blocks_chunk: Optional[int] = None

    # host-clock seconds of the last call, per stage (each read after a
    # device synchronise, so they include the device time); "staging" holds
    # the host->device copies of offload
    stage_seconds: Dict[str, Any] = dataclasses.field(default_factory=dict, repr=False)
    _staged: list = dataclasses.field(default_factory=list, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def _decode(self, z: torch.Tensor) -> torch.Tensor:
        if self.enable_vae_slicing and z.shape[0] > 1:
            return torch.cat([self._decode_one(z[i:i + 1]) for i in range(z.shape[0])])
        return self._decode_one(z)

    def _decode_one(self, z: torch.Tensor) -> torch.Tensor:
        vae = self._component("vae")
        if self.enable_vae_tiling:
            return vae_decode_tiled(vae, z)
        return vae_decode_wsplit(vae, z, decode_splits(z.shape[3]))

    def step_noise(self, gen: torch.Generator, shape) -> torch.Tensor:
        """DPM's noise for one step, f32 standard normal, drawn on every step
        (reuse steps too) after the initial latents. The JAX pipeline draws it
        from its own key sequence, which torch cannot reproduce: the tests
        replace this method to feed both pipelines the same noise."""
        return torch.randn(shape, generator=gen, device=self.device, dtype=torch.float32)

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
        return self._component("text_encoder")(ids).to(self.dtype)

    def encode_prompt(self, prompt: str, negative_prompt: str,
                      max_length: int = 226) -> Tuple[torch.Tensor, torch.Tensor]:
        return (self._t5_forward(self.encode_prompt_tokens(prompt, max_length)),
                self._t5_forward(self.encode_prompt_tokens(negative_prompt, max_length)))

    def _vae_encode_mode(self, video: torch.Tensor, image_cond: bool = False) -> torch.Tensor:
        """Posterior mode, scaled — except image-conditioning latents under
        ``invert_scale_latents`` (CogVideoX 1.5 was trained without that
        multiply; ``cogvideox_i2v_mot.py:86-94``)."""
        z = posterior_mode(vae_encode(self._component("vae"), video.to(self.dtype)))
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
        image: Optional[np.ndarray],             # [H, W, 3] float in [-1, 1]; None: T2V
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
        if self.offload_blocks_chunk:
            raise NotImplementedError("offload_blocks_chunk (streamed block offload) is not "
                                      "ported to PyTorch yet")
        use_dpm = isinstance(self.scheduler, CogVideoXDPMScheduler)
        if not use_dpm and not isinstance(self.scheduler, CogVideoXDDIMScheduler):
            raise ValueError(f"unknown scheduler {type(self.scheduler).__name__}; "
                             "CogVideoXDDIMScheduler or CogVideoXDPMScheduler")
        schedule = StepCacheSchedule(parse_step_cache(step_cache, num_inference_steps))
        # plain (no reference videos): the trunk alone, a crush_smol-style
        # finetune; with image=None the text-to-video model
        plain = not ref_videos and prompt_embeds_mot_ref is None
        t2v = plain and image is None
        single_branch = ablation_single_branch or baseline_single_condition or plain
        concat_refs = ablation_single_branch and not baseline_single_condition and not plain
        cfg = self.transformer.config
        times = self.stage_seconds
        times.clear()
        dev, dtype = self.device, self.dtype
        do_cfg = guidance_scale > 1.0
        mult = 2 if do_cfg else 1

        # 1. prompts
        if prompt_embeds is None:
            self._component("text_encoder")
        self._sync()
        t0 = time.perf_counter()
        if prompt_embeds is None:
            prompt_embeds, negative_prompt_embeds = self.encode_prompt(
                prompt, negative_prompt, max_sequence_length)
        embeds = torch.cat([negative_prompt_embeds, prompt_embeds]) if do_cfg else prompt_embeds
        embeds_ref = None
        if not plain:
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
        if not t2v:
            self._component("vae")
        t0 = time.perf_counter()
        num_latent_frames = (num_frames - 1) // self.vae_scale_factor_temporal + 1
        lat_h = height // self.vae_scale_factor_spatial
        lat_w = width // self.vae_scale_factor_spatial
        latent_channels = cfg.in_channels if t2v else cfg.in_channels // 2

        def pad_frames(z):
            pad = z.new_zeros((1, num_latent_frames - 1, lat_h, lat_w, latent_channels))
            return torch.cat([z, pad], dim=1)

        # channel-last -> transformer layout [B, F, C, H, W]
        def to_fchw(x):
            return x.permute(0, 1, 4, 2, 3).to(dtype)

        image_in = ref_in = None
        if not t2v:
            img = torch.as_tensor(np.asarray(image, np.float32), device=dev)[None, None]
            image_latents = pad_frames(self._vae_encode_mode(img, image_cond=True))
            image_in = to_fchw(image_latents).repeat(mult, 1, 1, 1, 1)
        num_mot_ref = 1
        if not plain:
            ref_lat_list, ref_img_lat_list = [], []
            for rv in ref_videos:
                rv_t = torch.as_tensor(np.asarray(rv, np.float32), device=dev)[None]
                ref_lat_list.append(self._vae_encode_mode(rv_t))
                ref_img_lat_list.append(
                    pad_frames(self._vae_encode_mode(rv_t[:, :1], image_cond=True)))
            ref_latents = torch.cat(ref_lat_list, dim=1)
            ref_image_latents = torch.cat(ref_img_lat_list, dim=1)
            num_mot_ref = ref_latents.shape[1] // num_latent_frames
            ref_in = torch.cat([to_fchw(ref_latents), to_fchw(ref_image_latents)],
                               dim=2).repeat(mult, 1, 1, 1, 1)

        # one generator: the initial latents (unless given), then DPM's
        # per-step noise
        gen = torch.Generator(device=dev).manual_seed(seed)
        if latents is None:
            latents = torch.randn((1, num_latent_frames, latent_channels, lat_h, lat_w),
                                  generator=gen, device=dev, dtype=torch.float32)
        latents = torch.as_tensor(latents, dtype=torch.float32, device=dev)
        latents = latents * self.scheduler.init_noise_sigma
        self._sync()
        times["vae_encode"] = time.perf_counter() - t0

        # 3. RoPE tables and per-step scalars
        rope = self._rope(height, width, num_latent_frames)
        rope_ref = (None if plain else
                    self._rope(height, width, num_latent_frames, num_mot_ref, ref_type))
        if concat_refs:
            rope = (torch.cat([rope[0], rope_ref[0]]), torch.cat([rope[1], rope_ref[1]]))
        ts = self.scheduler.timesteps(num_inference_steps).astype(np.float32)
        coeffs = [torch.from_numpy(c).to(dev) for c in
                  self.scheduler.step_coefficients(num_inference_steps)]
        guidance = (dynamic_cfg_schedule(ts, guidance_scale, num_inference_steps)
                    if use_dynamic_cfg else np.full_like(ts, guidance_scale))

        transformer = self._component("transformer")

        def raw_pred(latents, t):
            """One CFG-batch forward -> f32 [mult, F, C, H, W] (``:257-291``)."""
            latent_in = latents.to(dtype).repeat(mult, 1, 1, 1, 1)
            if not t2v:
                latent_in = torch.cat([latent_in, image_in], dim=2)
            timestep = torch.full((mult,), float(t), dtype=torch.float32, device=dev)
            if single_branch:
                if concat_refs:
                    latent_in = torch.cat([latent_in, ref_in], dim=1)
                pred = transformer(hidden_states=latent_in, encoder_hidden_states=embeds,
                                   timestep=timestep, image_rotary_emb=rope)
                return pred[:, :num_latent_frames].float()
            return transformer(
                hidden_states=latent_in, encoder_hidden_states=embeds, timestep=timestep,
                image_rotary_emb=rope, hidden_states_mot_ref=ref_in,
                encoder_hidden_states_mot_ref=embeds_ref, image_rotary_emb_mot_ref=rope_ref,
                num_mot_ref=num_mot_ref).float()

        # 4. denoise. The step cache keeps the raw CFG-batch prediction (f32,
        # before the CFG combine); every step, a reuse step too, recombines
        # CFG with its own guidance and advances the scheduler
        # (``cogvideox_i2v_mot.py:271-347``).
        step_times, computed = [], []
        cached = None
        old_x0 = torch.zeros_like(latents)
        for i, t in enumerate(ts):
            t0 = time.perf_counter()
            if schedule.compute(i, latents):
                cached = raw_pred(latents, t)
                computed.append(i)
            noise_pred = cached
            if do_cfg:
                uncond, cond = noise_pred.chunk(2)
                noise_pred = uncond + float(guidance[i]) * (cond - uncond)
            step_coeffs = tuple(c[i] for c in coeffs)
            if use_dpm:
                noise = self.step_noise(gen, latents.shape)
                latents, old_x0 = self.scheduler.step(noise_pred, latents, old_x0, step_coeffs,
                                                      noise)
            else:
                latents = self.scheduler.step(noise_pred, latents, *step_coeffs)
            self._sync()
            step_times.append(time.perf_counter() - t0)
        times["denoise_steps"] = step_times
        times["computed_steps"] = computed

        if output_type == "latent":
            return latents

        # 5. decode: channel-last, unscaled (the decode division keeps the
        # factor even under invert_scale_latents)
        self._component("vae")
        t0 = time.perf_counter()
        z = latents.permute(0, 1, 3, 4, 2).to(dtype) / self.vae.config.scaling_factor
        out = self._decode(z).float().cpu().numpy()
        times["vae_decode"] = time.perf_counter() - t0
        return out
