"""Control training's helpers and CogVideoX's control step.

Port of ``vap_tpu/training/control.py``: the input layer widened for
[noisy ‖ control] latents (``expand_patch_embed_for_control`` :27; the old
weights kept, the new inputs at zero, so training starts at the
unconditioned function), the host-side control signals (``canny_control``
:42, ``frame_conditioning_control`` :55), and CogVideoX's control loss and
step (``control_loss`` / ``make_control_train_step``, :68-142): the
v-prediction loss over [noisy ‖ control latents] along channels, the trunk
alone, with the widened input layer trained (or, ``full_finetune``, every
parameter). The Wan control trainer is ``training/control_trainer.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..models.cogvideox.config import CogVideoXMOTConfig
from ..ops.schedulers.common import add_noise
from .train_step import Metrics, _alphas_cumprod, _rope_tables, _x0_error


def expand_patch_embed_for_control(model: nn.Module, extra_in_features: int,
                                   frame_conditioning_mask: bool = False) -> nn.Module:
    """Widen CogVideoX's ``patch_embed.proj`` in place by
    ``extra_in_features`` (+1 with the mask) input features of its
    patchified rows (JAX appends zero rows to the [C * p * p, D] kernel).
    Here the Conv2d takes whole channels, so the extra features must be a
    multiple of p * p (the Linear of CogVideoX 1.5, any count). The config's
    ``in_channels`` follows. Returns the model."""
    proj = model.patch_embed.proj
    extra = extra_in_features + (1 if frame_conditioning_mask else 0)
    cfg = model.config
    with torch.no_grad():
        if isinstance(proj, nn.Linear):
            new = nn.Linear(proj.in_features + extra, proj.out_features, device=proj.weight.device,
                            dtype=proj.weight.dtype)
            new.weight.zero_()
            new.weight[:, :proj.in_features] = proj.weight
            per_channel = proj.in_features // cfg.in_channels
        else:
            per_channel = proj.kernel_size[0] * proj.kernel_size[1]
            if extra % per_channel:
                raise ValueError(f"{extra} extra input features do not make whole channels of "
                                 f"the {proj.kernel_size} patch ({per_channel} features each)")
            new = nn.Conv2d(proj.in_channels + extra // per_channel, proj.out_channels,
                            proj.kernel_size, stride=proj.stride, device=proj.weight.device,
                            dtype=proj.weight.dtype)
            new.weight.zero_()
            new.weight[:, :proj.in_channels] = proj.weight
        new.bias.copy_(proj.bias)
    new.requires_grad_(proj.weight.requires_grad)
    model.patch_embed.proj = new
    if extra % per_channel == 0:
        model.config = dataclasses.replace(cfg, in_channels=cfg.in_channels + extra // per_channel)
    return model


def canny_control(video: np.ndarray, low: int = 100, high: int = 200) -> np.ndarray:
    """Canny edges per frame: [F, H, W, 3] in [-1, 1] -> the same shape,
    the edges replicated over the three channels (the reference's
    CannyProcessor). OpenCV is imported at the call (``data/video.py``)."""
    from ..data.video import canny_edges

    edges = canny_edges(((video + 1.0) * 127.5).astype(np.uint8), low, high)
    return np.repeat(edges[..., None], 3, axis=-1).astype(np.float32) / 127.5 - 1.0


def frame_conditioning_control(video: np.ndarray, mode: str = "first") -> np.ndarray:
    """Frame-conditioning control: every frame the first (``first``), or
    zeros but the first and last frames (``first_and_last``); zeros for
    any other mode."""
    out = np.zeros_like(video)
    if mode == "first":
        out[:] = video[:1]
    elif mode == "first_and_last":
        out[:] = 0
        out[0] = video[0]
        out[-1] = video[-1]
    return out


@dataclasses.dataclass(frozen=True)
class ControlTrainStepConfig:
    model: CogVideoXMOTConfig      # in_channels widened for the control
    control_type: str = "canny"    # canny | frame_conditioning
    num_train_timesteps: int = 1000
    remat: Union[bool, str] = True


def control_loss(model: nn.Module, cfg: ControlTrainStepConfig, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None, *,
                 timesteps: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Metrics]:
    """CogVideoX's control loss (``control_loss``): the uniform timestep and
    the noise (drawn from ``generator`` in that order when not given),
    ``add_noise`` under the zero-terminal-SNR table, the trunk over
    [noisy ‖ control_latents] along channels, the x0 prediction against the
    clean latents weighted by 1 / (1 - alpha_bar_t). batch: ``latents`` and
    ``control_latents`` [B, F, C, H, W], ``encoder_hidden_states``."""
    latents = batch["latents"].float()
    b, f_lat, _, lat_h, lat_w = latents.shape
    device = latents.device
    alphas_cumprod = _alphas_cumprod(device)
    if timesteps is None:
        timesteps = torch.randint(0, cfg.num_train_timesteps, (b,), generator=generator,
                                  device=device)
    if noise is None:
        noise = torch.randn(latents.shape, generator=generator, device=device,
                            dtype=torch.float32)
    timesteps, noise = timesteps.to(device), noise.to(device, torch.float32)
    noisy = add_noise(alphas_cumprod, latents, noise, timesteps)
    hidden = torch.cat([noisy, batch["control_latents"].float()], dim=2)
    rope, _ = _rope_tables(cfg.model, lat_h, lat_w, f_lat, 0, "continous_negative", device)
    dtype = batch["encoder_hidden_states"].dtype
    velocity = model(hidden.to(dtype), batch["encoder_hidden_states"], timesteps.float(), rope,
                     remat=cfg.remat)
    loss = torch.mean(_x0_error(alphas_cumprod, velocity, noisy, timesteps, latents))
    return loss, {"loss": loss.detach()}


def control_trainable_names(model: nn.Module) -> list:
    """The widened input layer's parameters (``control_trainable_mask``:
    every leaf under ``patch_embed`` / ``proj``)."""
    return [n for n, _ in model.named_parameters() if n.startswith("patch_embed.proj.")]


def make_control_train_step(cfg: ControlTrainStepConfig, model: nn.Module,
                            make_optimizer: Callable, full_finetune: bool = False):
    """CogVideoX's control step (``make_control_train_step``): the widened
    input layer trains (every parameter under ``full_finetune``), the rest is
    frozen. Returns (optimizer, ``step_fn(model, batch, generator=None,
    **draws) -> metrics`` with ``grad_norm``)."""
    from .train_step import make_train_step

    train = set(n for n, _ in model.named_parameters()) if full_finetune else \
        set(control_trainable_names(model))
    for n, p in model.named_parameters():
        p.requires_grad_(n in train)
    optimizer = make_optimizer([p for n, p in model.named_parameters() if n in train])
    return optimizer, make_train_step(cfg, optimizer, control_loss)
