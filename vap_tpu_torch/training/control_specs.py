"""The Wan control spec: the encoders and the sampling of control training.

Port of ``vap_tpu/training/control_specs.py`` ``WanControlSpec`` (:42-128,
the reference's WanControlModelSpecification). The text conditions are
``WanSpec``'s (UMT5, zero past the prompt; the T2V base takes no image
states); ``prepare_latents`` VAE-encodes the clip and its control video
(``latents`` and ``control_latents``, normalised, channel-last); and
``validation`` samples with the live transformer: FlowMatch Euler at shift
3 with classifier-free guidance 5.0 on a batch of two ([prompt, negative
prompt]), the frame-conditioned control latents concatenated to x along
channels at every step, then the VAE decode. The starting noise is drawn
from a generator seeded with ``seed`` and the frame draws from one seeded
with ``seed + 1`` (JAX: ``PRNGKey(seed)`` and ``PRNGKey(seed + 1)``), or
given (``noise``, ``keep``).

CogView4's control spec comes with that family (ROADMAP Queue 1 #7).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..data.generic import _load_video_norm
from ..models.wan.vae import denormalize_latents, wan_vae_decode_streamed
from ..ops.schedulers.flow_match import FlowMatchEulerScheduler
from .control import canny_control
from .control_trainer import apply_frame_conditioning_on_latents, frame_keep_mask
from .specs import SUPPORTED_MODEL_SPECS, WanSpec


def _load_media(sample: Dict[str, Any], key: str) -> Optional[np.ndarray]:
    """A video column as a normalised [-1, 1] array: an array, or a path."""
    v = sample.get(key)
    if v is None:
        return None
    if isinstance(v, str):
        return _load_video_norm(v)
    return np.asarray(v, np.float32)


class WanControlSpec(WanSpec):
    """Wan2.1 T2V control spec; the transformer is the widened one."""

    ENCODERS = ("vae", "text_encoder")
    image_encoder = None  # the T2V base reads no image states

    @torch.no_grad()
    def prepare_latents(self, sample: Dict[str, Any]) -> Dict[str, Any]:
        control = sample.get("control_video")
        if control is None:
            raise ValueError("control training requires a control_video column "
                             "(use ControlDatasetWrapper)")
        pipe = self.pipeline()

        def enc(video: np.ndarray) -> np.ndarray:
            return pipe._vae_encode(self._video(video)).detach().float().cpu().numpy()

        return {"latents": enc(sample["video"]), "control_latents": enc(control)}

    @torch.no_grad()
    def validation(self, sample: Dict[str, Any], *, num_inference_steps: int = 30,
                   seed: int = 42, guidance_scale: float = 5.0, shift: float = 3.0,
                   frame_conditioning_type: str = "full", frame_conditioning_index: int = 0,
                   concatenate_mask: bool = False, noise: Optional[torch.Tensor] = None,
                   keep: Optional[torch.Tensor] = None, **_) -> np.ndarray:
        """One sample [F, H, W, 3] in [-1, 1]: ``sample`` has a caption and a
        ``control_video`` (array or path; else the canny edges of its
        ``video``), optionally a ``negative_prompt``."""
        control = _load_media(sample, "control_video")
        if control is None:
            video = _load_media(sample, "video")
            if video is None:
                raise ValueError("validation sample needs control_video or video")
            control = canny_control(video)
        pipe = self.pipeline()
        dev, dtype = self.device, self.dtype
        ctrl_lat = pipe._vae_encode(self._video(control)).float()
        text = torch.cat([pipe.encode_prompt(sample["caption"]),
                          pipe.encode_prompt(sample.get("negative_prompt", ""))]).to(dtype)
        if keep is None:
            keep = frame_keep_mask(1, ctrl_lat.shape[1], frame_conditioning_type,
                                   frame_conditioning_index,
                                   torch.Generator(device=dev).manual_seed(seed + 1), dev)
        ctrl = apply_frame_conditioning_on_latents(ctrl_lat, concatenate_mask=concatenate_mask,
                                                   keep=keep.to(dev))
        ctrl2 = torch.cat([ctrl, ctrl]).to(dtype)
        sched = FlowMatchEulerScheduler(shift=shift)
        sigmas = sched.sigmas(num_inference_steps)
        if noise is None:
            noise = torch.randn(tuple(ctrl_lat.shape[:4]) + (self.transformer_cfg.out_channels,),
                                generator=torch.Generator(device=dev).manual_seed(seed),
                                device=dev, dtype=torch.float32)
        x = noise.to(dev, torch.float32)
        for i in range(num_inference_steps):
            sigma, sigma_next = sigmas[i], sigmas[i + 1]
            hidden = torch.cat([torch.cat([x, x]).to(dtype), ctrl2], dim=-1)
            t = torch.full((2,), float(np.float32(sigma) * np.float32(1000.0)),
                           dtype=torch.float32, device=dev)
            v = self.transformer(hidden_states=hidden, timestep=t,
                                 encoder_hidden_states=text).float()
            v_c, v_u = v.chunk(2)
            x = sched.step(v_u + guidance_scale * (v_c - v_u), x, sigma, sigma_next)
        z = denormalize_latents(self.vae.config, x).to(dtype)
        video = wan_vae_decode_streamed(self.vae, z)
        return video[0].float().clamp(-1, 1).cpu().numpy()


for _tt in ("control_lora", "control_full_finetune"):
    SUPPORTED_MODEL_SPECS[("wan", _tt)] = WanControlSpec
