"""The CogVideoX Video-As-Prompt SFT step in PyTorch.

Port of ``vap_tpu/training/train_step.py`` for the VAP branch with a clean
reference (``reference_train_mode=None``):
  * a uniform timestep and Gaussian noise per sample; ``add_noise`` on the
    target latents under the zero-terminal-SNR table;
  * the model input is [noisy ‖ image latents] (channels), and the
    reference branch gets [clean reference latents ‖ its image latents];
  * pred = get_velocity(ᾱ, velocity, noisy, t), the x0 prediction, against
    the clean latents, weighted by 1 / (1 - ᾱ_t) (1 at t = 999, where
    ᾱ = 0; above 1e3 at small t), in float32;
  * only the MoT expert trains: every parameter whose name has no
    ``TRAINABLE_MARKERS`` entry gets ``requires_grad_(False)``. Activation
    gradients still flow through the frozen trunk, whose weights get none.

Timesteps and noise come from a ``torch.Generator``, or are given
explicitly (the tests pass JAX's draws). Not ported (they raise):
``reference_independent`` (with its ``random_refer_noise``), the plain
no-reference loss and the single-branch ablations. LoRA SFT and DPO are
not ported either.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from ..models.cogvideox.config import CogVideoXMOTConfig
from ..ops.rope import prepare_cogvideox_rotary_embeddings
from ..ops.schedulers.common import add_noise, get_velocity, make_alphas_cumprod
from .optimizer import Optimizer

TRAINABLE_MARKERS = ("_mot_ref", "effect_embeddings", "ref_embeddings")
Metrics = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    """The fields of the JAX ``TrainStepConfig`` this loss reads; the two
    that select a loss not ported yet raise when set."""
    model: CogVideoXMOTConfig
    reference_train_mode: Optional[str] = None   # "reference_independent": not ported
    ref_type: str = "continous_negative"
    num_train_timesteps: int = 1000
    remat: Union[bool, str] = True
    ablation_single_branch: bool = False         # not ported

    def __post_init__(self):
        if self.reference_train_mode is not None or self.ablation_single_branch:
            raise NotImplementedError(
                "reference_independent and the single-branch ablations are not ported to "
                "PyTorch yet")


def trainable_mask(model: nn.Module) -> List[str]:
    """Freeze every parameter whose name holds no trainable marker (the MoT
    expert's ``_mot_ref`` modules train, cf. ``trainable_mask``,
    train_step.py:125); returns the names of those that train."""
    names = []
    for name, p in model.named_parameters():
        train = any(m in name for m in TRAINABLE_MARKERS)
        p.requires_grad_(train)
        if train:
            names.append(name)
    return names


def _rope_tables(cfg: CogVideoXMOTConfig, lat_h: int, lat_w: int, lat_f: int, mot_num: int,
                 ref_type: str, device=None):
    if cfg.patch_size_t is not None:
        raise NotImplementedError("temporal patching (patch_size_t) is not ported")
    kw = dict(attention_head_dim=cfg.attention_head_dim, patch_size=cfg.patch_size,
              sample_width=cfg.sample_width, sample_height=cfg.sample_height, device=device)
    rope = prepare_cogvideox_rotary_embeddings(lat_h * 8, lat_w * 8, lat_f, **kw)
    rope_ref = prepare_cogvideox_rotary_embeddings(lat_h * 8, lat_w * 8, lat_f, mot_num=mot_num,
                                                   ref_type=ref_type, **kw)
    return rope, rope_ref


def cogvideox_vap_loss(model: nn.Module, cfg: TrainStepConfig, batch: Dict[str, torch.Tensor],
                       generator: Optional[torch.Generator] = None, *,
                       timesteps: Optional[torch.Tensor] = None,
                       noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Metrics]:
    """The VAP loss of ``cogvideox_vap_loss`` (train_step.py:208-292 with a
    clean reference). batch: ``latents``, ``image_latents`` [B, F, C, H, W],
    ``latents_mot_ref``, ``image_latents_mot_ref`` [B, R*F, C, H, W] (VAE
    scaled), ``encoder_hidden_states`` [B, T, Dt] and
    ``encoder_hidden_states_mot_ref`` [B, R*T, Dt], on the model's device.
    ``timesteps`` [B] and ``noise`` (the latents' shape) are drawn from
    ``generator`` when not given."""
    if "latents_mot_ref" not in batch:
        raise NotImplementedError("the plain (no-reference) loss is not ported to PyTorch yet")
    latents = batch["latents"].float()
    b, f_lat, _, lat_h, lat_w = latents.shape
    device = latents.device
    alphas_cumprod = torch.from_numpy(make_alphas_cumprod(rescale_betas_zero_snr=True)).to(device)
    if timesteps is None:
        timesteps = torch.randint(0, cfg.num_train_timesteps, (b,), generator=generator,
                                  device=device)
    if noise is None:
        noise = torch.randn(latents.shape, generator=generator, device=device,
                            dtype=torch.float32)
    timesteps, noise = timesteps.to(device), noise.to(device, torch.float32)
    noisy = add_noise(alphas_cumprod, latents, noise, timesteps)

    latents_ref = batch["latents_mot_ref"].float()
    num_mot_ref = latents_ref.shape[1] // f_lat
    hidden = torch.cat([noisy, batch["image_latents"].float()], dim=2)
    hidden_ref = torch.cat([latents_ref, batch["image_latents_mot_ref"].float()], dim=2)
    rope, rope_ref = _rope_tables(cfg.model, lat_h, lat_w, f_lat, num_mot_ref, cfg.ref_type,
                                  device)
    dtype = next(model.parameters()).dtype
    velocity = model(hidden.to(dtype), batch["encoder_hidden_states"].to(dtype),
                     timesteps.float(), rope, hidden_ref.to(dtype),
                     batch["encoder_hidden_states_mot_ref"].to(dtype), rope_ref,
                     num_mot_ref=num_mot_ref, remat=cfg.remat)
    pred = get_velocity(alphas_cumprod, velocity.float(), noisy, timesteps)
    weights = (1.0 / (1.0 - alphas_cumprod[timesteps])).reshape(b, 1, 1, 1, 1)
    loss = torch.mean(weights * torch.square(pred - latents))
    return loss, {"loss": loss.detach(), "loss_main": loss.detach()}


LossFn = Callable[..., Tuple[torch.Tensor, Metrics]]


def make_grad_and_apply(loss_fn: LossFn, cfg: TrainStepConfig, optimizer: Optimizer):
    """The split step of ``make_grad_and_apply`` (train_step.py:295-323),
    for gradient accumulation.

    ``grad_fn(model, batch, generator=None, clock=None, **draws) -> metrics``
    adds this micro-batch's gradient into the trainable parameters' ``.grad``
    (their sum over micro-batches), calling ``clock("forward")`` once the
    loss is computed and ``clock("backward")`` once it is differentiated;
    ``apply_fn(scale) -> grad_norm`` multiplies the
    summed gradients by ``scale`` (1/accumulation: their mean), reports the
    global norm before clipping, clips, takes one optimizer update and clears
    the gradients."""

    def grad_fn(model: nn.Module, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                clock: Optional[Callable[[str], None]] = None, **draws) -> Metrics:
        loss, metrics = loss_fn(model, cfg, batch, generator, **draws)
        if clock:
            clock("forward")
        loss.backward()
        if clock:
            clock("backward")
        return metrics

    def apply_fn(scale: float = 1.0) -> torch.Tensor:
        if scale != 1.0:
            with torch.no_grad():
                for p in optimizer.params:
                    if p.grad is not None:
                        p.grad.mul_(scale)
        grad_norm = optimizer.step()
        optimizer.zero_grad()
        return grad_norm

    return grad_fn, apply_fn


def make_train_step(cfg: TrainStepConfig, optimizer: Optimizer):
    """The CogVideoX VAP SFT step (``make_train_step``, train_step.py:414):
    ``step_fn(model, batch, generator=None, **draws) -> metrics`` takes one
    micro-batch and one optimizer update, with ``grad_norm`` in the
    metrics. Call ``trainable_mask(model)`` before building the optimizer."""
    grad_fn, apply_fn = make_grad_and_apply(cogvideox_vap_loss, cfg, optimizer)

    def step_fn(model: nn.Module, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None, **draws) -> Metrics:
        metrics = grad_fn(model, batch, generator, **draws)
        metrics["grad_norm"] = apply_fn()
        return metrics

    return step_fn
