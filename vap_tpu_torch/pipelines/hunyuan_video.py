"""HunyuanVideo text-to-video pipeline in PyTorch.

Port of ``vap_tpu/pipelines/hunyuan_video.py:22-152``
(``HunyuanVideoPipeline.__call__``): the LLaMA prompt embeddings of the
llava template, the template's ``crop_start`` tokens dropped, taken from
hidden state -3; the CLIP-L pooled prompt; guidance distilled into an
embedding (guidance x 1000, one forward per step); FlowMatch Euler with the
constant shift (7.0) over ``linspace(1, 0, N + 1)[:-1]``, as a Python loop
over steps; then the decode with ``1 / scaling_factor``, clipped to
[-1, 1].

The text mask must be a contiguous right-padded prefix: the transformer
reduces it to one valid key count per sample for K7, the varlen attention.
``encode_prompt`` checks it while the mask is still on the host.

With ``enable_model_offload`` every component stays in host memory and
one at a time is staged onto the card (``pipelines/offload.py``). The
tokenizers are the caller's, as in the JAX tests. Latents come from a
``torch.Generator`` seeded with ``seed`` (torch cannot draw JAX's numbers:
pass ``latents`` to compare with the JAX pipeline).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..models.hunyuan_video.transformer import HunyuanVideoTransformer3DModel
from ..models.hunyuan_video.vae import AutoencoderKLHunyuanVideo, hunyuan_vae_decode
from ..models.text_encoders.clip_text import CLIPTextModel
from ..models.text_encoders.llama import LlamaModel
from .cogvideox_i2v_mot import resolve_device
from .offload import StagedComponents

# --- copied from vap_tpu/pipelines/hunyuan_video.py:26-37 --------------------
# the reference's default llava template (pipeline_hunyuan_video.py:70-83)
DEFAULT_PROMPT_TEMPLATE_PREFIX = (
    "<|start_header_id|>system<|end_header_id|>\n\nDescribe the video by detailing "
    "the following aspects: 1. The main content and theme of the video."
    "2. The color, shape, size, texture, quantity, text, and spatial relationships of the objects."
    "3. Actions, events, behaviors temporal relationships, physical movement changes of the objects."
    "4. background environment, light, style and atmosphere."
    "5. camera angles, movements, and transitions used in the video:<|eot_id|>"
    "<|start_header_id|>user<|end_header_id|>\n\n"
)
DEFAULT_PROMPT_TEMPLATE_SUFFIX = "<|eot_id|>"
CROP_START = 95  # tokens of the template's prefix
HIDDEN_LAYER = -3  # num_hidden_layers_to_skip = 2


def shift_sigmas_constant(sigmas: np.ndarray, shift: float) -> np.ndarray:
    """FlowMatch Euler's constant shift: s * sigma / (1 + (s - 1) * sigma)."""
    return shift * sigmas / (1.0 + (shift - 1.0) * sigmas)


def flow_sigmas(num_inference_steps: int, shift: float) -> np.ndarray:
    """The shifted sigmas of ``linspace(1, 0, N + 1)[:-1]`` with a terminal
    0, float32 (len N + 1)."""
    sigmas = shift_sigmas_constant(np.linspace(1.0, 0.0, num_inference_steps + 1)[:-1], shift)
    return np.append(sigmas, 0.0).astype(np.float32)


@dataclasses.dataclass
class HunyuanVideoPipeline(StagedComponents):
    COMPONENTS = ("transformer", "vae", "text_encoder", "text_encoder_2")

    transformer: HunyuanVideoTransformer3DModel
    vae: AutoencoderKLHunyuanVideo
    text_encoder: LlamaModel
    text_encoder_2: CLIPTextModel
    tokenizer: Any = None       # the LLaMA tokenizer
    clip_tokenizer: Any = None  # the CLIP tokenizer (the LLaMA one when None)
    dtype: torch.dtype = torch.bfloat16
    flow_shift: float = 7.0
    # the card unless the caller asks for the CPU; raises where there is no card
    device: torch.device = torch.device("cuda")
    # weights on the host, one component at a time staged onto the device
    enable_model_offload: bool = False

    # host-clock seconds of the last call, per stage, each read after a
    # device synchronise; "staging" holds the host->device copies of offload
    stage_seconds: Dict[str, Any] = dataclasses.field(default_factory=dict, repr=False)
    _staged: list = dataclasses.field(default_factory=list, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def encode_prompt(self, prompt: str, max_length: int = 256, use_template: bool = True,
                      crop_start: int = CROP_START):
        """(LLaMA states [1, L, D] in ``dtype``, their mask [1, L] float32,
        CLIP pooled [1, D2] in ``dtype``), L = ``max_length``."""
        text = (DEFAULT_PROMPT_TEMPLATE_PREFIX + prompt + DEFAULT_PROMPT_TEMPLATE_SUFFIX
                if use_template else prompt)
        pad_len = max_length + (crop_start if use_template else 0)
        toks = self.tokenizer([text], padding="max_length", max_length=pad_len, truncation=True,
                              return_tensors="np")
        mask_np = np.asarray(toks["attention_mask"], np.float32)
        ids = torch.from_numpy(np.asarray(toks["input_ids"], np.int64)).to(self.device)
        hidden = self._component("text_encoder")(
            ids, torch.from_numpy(mask_np).to(self.device), hidden_layer=HIDDEN_LAYER)
        if use_template:
            hidden = hidden[:, crop_start:]
            mask_np = mask_np[:, crop_start:]
        # the transformer reduces the mask to per-sample key counts (K7):
        # it must be a contiguous right-padded prefix, checked here on the host
        lens = mask_np.sum(axis=-1).astype(np.int64)
        prefix = (np.arange(mask_np.shape[-1])[None, :] < lens[:, None]).astype(np.float32)
        if not np.array_equal(mask_np, prefix):
            raise ValueError("LLaMA attention mask is not a contiguous right-padded prefix; "
                             "the varlen attention assumes suffix padding. Use a "
                             "right-padding tokenizer configuration.")
        clip = self._component("text_encoder_2")
        clip_len = min(77, clip.config.max_position_embeddings)
        ctoks = (self.clip_tokenizer or self.tokenizer)(
            [prompt], padding="max_length", max_length=clip_len, truncation=True,
            return_tensors="np")
        _, pooled = clip(torch.from_numpy(np.asarray(ctoks["input_ids"], np.int64)).to(self.device))
        mask = torch.from_numpy(np.ascontiguousarray(mask_np)).to(self.device)
        return hidden.to(self.dtype), mask, pooled.to(self.dtype)

    @torch.inference_mode()
    def __call__(self, prompt: str, height: int = 720, width: int = 1280, num_frames: int = 129,
                 num_inference_steps: int = 50, guidance_scale: float = 6.0, seed: int = 0,
                 max_sequence_length: int = 256, use_template: bool = True,
                 latents: Optional[torch.Tensor] = None, output_type: str = "np"):
        """Returns the video [1, F, H, W, 3] in [-1, 1] as numpy, or with
        ``output_type="latent"`` the final latents [1, C, f, h, w] float32
        before the unscale. ``latents`` (same layout) replaces the draw."""
        times = self.stage_seconds
        times.clear()
        dev, dtype = self.device, self.dtype
        vae_cfg = self.vae.config
        sc, tc = vae_cfg.spatial_compression_ratio, vae_cfg.temporal_compression_ratio
        shape = (1, vae_cfg.latent_channels, (num_frames - 1) // tc + 1, height // sc, width // sc)

        self._component("text_encoder")
        t0 = time.perf_counter()
        embeds, mask, pooled = self.encode_prompt(prompt, max_sequence_length, use_template)
        self._sync()
        times["text_encode"] = time.perf_counter() - t0

        if latents is None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            latents = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        latents = torch.as_tensor(latents, dtype=torch.float32, device=dev)

        transformer = self._component("transformer")
        sig = flow_sigmas(num_inference_steps, self.flow_shift)
        deltas = sig[1:] - sig[:-1]
        guidance = torch.full((1,), guidance_scale * 1000.0, dtype=torch.float32, device=dev)
        step_times = []
        for i in range(num_inference_steps):
            t0 = time.perf_counter()
            timestep = torch.full((1,), float(sig[i]), dtype=torch.float32, device=dev) * 1000.0
            pred = transformer(hidden_states=latents.to(dtype), encoder_hidden_states=embeds,
                               pooled_projections=pooled, timestep=timestep, guidance=guidance,
                               encoder_attention_mask=mask).float()
            latents = latents + float(deltas[i]) * pred
            self._sync()
            step_times.append(time.perf_counter() - t0)
        times["denoise_steps"] = step_times
        if output_type == "latent":
            return latents  # before the unscale, as in the reference pipeline

        vae = self._component("vae")
        t0 = time.perf_counter()
        z = (latents / vae_cfg.scaling_factor).permute(0, 2, 3, 4, 1).to(dtype)
        video = hunyuan_vae_decode(vae, z).float().clamp_(-1.0, 1.0).cpu().numpy()
        times["vae_decode"] = time.perf_counter() - t0
        return video
