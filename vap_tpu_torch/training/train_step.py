"""The Video-As-Prompt SFT steps in PyTorch: the CogVideoX VAP loss, the Wan
flow-matching loss and LoRA SFT.

Port of ``vap_tpu/training/train_step.py``. The CogVideoX VAP branch with a
clean reference (``reference_train_mode=None``):
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

The Wan loss (``wan_vap_loss``, :530): sigmas drawn by the flow-matching
density of ``flow_weighting_scheme`` on the FlowMatch training grid, x_t =
(1 - sigma) x0 + sigma n, the target n - x0, the loss weighted per sample by
``flow_loss_weights``; the plain branch (no reference in the batch: the
trunk alone, T2V without conditioning channels) and the MoT branch (clean
references at t = 1).

LoRA SFT (``make_lora_sft_step``, :346): adapters over the targeted
projections of a frozen model (``training/lora.py``); only they train.

Timesteps, sigmas and noise come from a ``torch.Generator``, or are given
explicitly (the tests pass JAX's draws). Not ported (they raise):
``reference_independent`` (with its ``random_refer_noise``), the plain
no-reference CogVideoX loss and the single-branch ablations; DPO is not
ported either.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..models.cogvideox.config import CogVideoXMOTConfig
from ..ops.rope import prepare_cogvideox_rotary_embeddings
from ..ops.schedulers.common import add_noise, get_velocity, make_alphas_cumprod
from .lora import DEFAULT_TARGETS, LoRATree, apply_lora, init_lora, lora_parameters
from .optimizer import Optimizer

TRAINABLE_MARKERS = ("_mot_ref", "effect_embeddings", "ref_embeddings")
FLOW_WEIGHTING_SCHEMES = ("none", "logit_normal", "mode", "sigma_sqrt", "cosmap")
Metrics = Dict[str, torch.Tensor]


def sample_flow_sigmas(batch_size: int, *, scheme: str = "none", logit_mean: float = 0.0,
                       logit_std: float = 1.0, mode_scale: float = 1.29,
                       num_train_timesteps: int = 1000, shift: float = 1.0,
                       generator: Optional[torch.Generator] = None, device=None,
                       draw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Training sigmas of the flow-matching families (``sample_flow_sigmas``,
    train_step.py:45): a density u per scheme (logit_normal: sigmoid(N(mean,
    std)); mode: the mode-scale curve; otherwise uniform), the FlowMatch
    Euler grid sigma = (N - i) / N at i = floor(u N), then the shift
    s sigma / (1 + (s - 1) sigma). ``draw`` [B] is the standard normal
    (logit_normal) or uniform (the other schemes) draw, taken from
    ``generator`` when not given."""
    if scheme not in FLOW_WEIGHTING_SCHEMES:
        raise ValueError(f"unknown flow_weighting_scheme {scheme!r}; "
                         f"valid: {FLOW_WEIGHTING_SCHEMES}")
    if draw is None:
        sample = torch.randn if scheme == "logit_normal" else torch.rand
        draw = sample(batch_size, generator=generator, device=device, dtype=torch.float32)
    draw = draw.to(device=device, dtype=torch.float32)
    if scheme == "logit_normal":
        u = torch.sigmoid(logit_mean + logit_std * draw)
    elif scheme == "mode":
        u = 1.0 - draw - mode_scale * (torch.cos(math.pi * draw / 2.0) ** 2 - 1.0 + draw)
    else:  # sigma_sqrt and cosmap re-weight the loss, not the sampling density
        u = draw
    n = num_train_timesteps
    idx = torch.clamp((u * n).to(torch.int32), 0, n - 1)
    sigmas = (n - idx).float() / n
    if shift != 1.0:
        sigmas = shift * sigmas / (1.0 + (shift - 1.0) * sigmas)
    return sigmas


def flow_loss_weights(sigmas: torch.Tensor, scheme: str = "none") -> torch.Tensor:
    """Per-sample loss weights (``flow_loss_weights``, train_step.py:83):
    sigma_sqrt sigma^-2, cosmap 2 / (pi (1 - 2 sigma + 2 sigma^2)), else 1."""
    if scheme == "sigma_sqrt":
        return sigmas ** -2.0
    if scheme == "cosmap":
        return 2.0 / (math.pi * (1.0 - 2.0 * sigmas + 2.0 * sigmas ** 2))
    return torch.ones_like(sigmas)


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


@dataclasses.dataclass(frozen=True)
class WanTrainStepConfig:
    """The JAX ``WanTrainStepConfig``: the Wan loss's flow-matching settings."""
    model: Any  # WanMOTConfig
    num_train_timesteps: int = 1000
    flow_weighting_scheme: str = "none"
    flow_logit_mean: float = 0.0
    flow_logit_std: float = 1.0
    flow_mode_scale: float = 1.29
    remat: Union[bool, str] = True


def wan_vap_loss(model: nn.Module, cfg: WanTrainStepConfig, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None, *,
                 sigmas: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Metrics]:
    """The Wan flow-matching loss of ``wan_vap_loss`` (train_step.py:530-584).
    batch, channel-last [B, F, H, W, C], latents already normalised:
    ``latents`` [.., 16], ``encoder_hidden_states`` [B, 512, Dt], and
    optionally ``condition`` [.., 20] (mask + first-frame latent, I2V) and
    ``encoder_hidden_states_image`` [B, 257, D_img]; with
    ``latents_mot_ref`` [B, R*F, .., 16] the MoT branch also reads
    ``condition_mot_ref`` and the ``*_mot_ref`` text and image states. Without
    it the model runs its trunk alone (the plain finetune). ``sigmas`` [B] and
    ``noise`` (the latents' shape) are drawn from ``generator`` when not
    given. The precomputed states go into the model in its dtype."""
    latents = batch["latents"].float()
    b, f_lat = latents.shape[:2]
    device = latents.device
    if sigmas is None:
        sigmas = sample_flow_sigmas(b, scheme=cfg.flow_weighting_scheme,
                                    logit_mean=cfg.flow_logit_mean, logit_std=cfg.flow_logit_std,
                                    mode_scale=cfg.flow_mode_scale,
                                    num_train_timesteps=cfg.num_train_timesteps,
                                    generator=generator, device=device)
    if noise is None:
        noise = torch.randn(latents.shape, generator=generator, device=device,
                            dtype=torch.float32)
    sigmas, noise = sigmas.to(device, torch.float32), noise.to(device, torch.float32)
    timesteps = sigmas * cfg.num_train_timesteps
    s = sigmas.reshape(b, 1, 1, 1, 1)
    noisy = (1.0 - s) * latents + s * noise  # flow_match_xt
    target = noise - latents
    loss_w = flow_loss_weights(sigmas, cfg.flow_weighting_scheme).reshape(b, 1, 1, 1, 1)

    dtype = next(model.parameters()).dtype

    def states(name):
        x = batch.get(name)
        return None if x is None else x.to(dtype)

    hidden = noisy
    if "condition" in batch:
        hidden = torch.cat([noisy, batch["condition"].float()], dim=-1)
    kwargs = dict(hidden_states=hidden.to(dtype), timestep=timesteps,
                  encoder_hidden_states=states("encoder_hidden_states"),
                  encoder_hidden_states_image=states("encoder_hidden_states_image"),
                  remat=cfg.remat)
    if "latents_mot_ref" in batch:
        latents_ref = batch["latents_mot_ref"].float()
        num_mot_ref = latents_ref.shape[1] // f_lat
        hidden_ref = torch.cat([latents_ref, batch["condition_mot_ref"].float()], dim=-1)
        kwargs.update(hidden_states_mot_ref=hidden_ref.to(dtype),
                      timestep_mot_ref=torch.ones((b, num_mot_ref), device=device),
                      encoder_hidden_states_mot_ref=states("encoder_hidden_states_mot_ref"),
                      encoder_hidden_states_image_mot_ref=states(
                          "encoder_hidden_states_image_mot_ref"),
                      num_mot_ref=num_mot_ref)
    velocity = model(**kwargs)
    loss = torch.mean(loss_w * torch.square(velocity.float() - target))
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


def make_train_step(cfg: TrainStepConfig, optimizer: Optimizer,
                    loss_fn: LossFn = cogvideox_vap_loss):
    """One micro-batch and one optimizer update (``make_train_step``,
    train_step.py:414; the CogVideoX VAP loss unless ``loss_fn`` is given):
    ``step_fn(model, batch, generator=None, **draws) -> metrics``, with
    ``grad_norm`` in the metrics. Freeze what does not train
    (``trainable_mask`` or ``install_lora``) before building the optimizer."""
    grad_fn, apply_fn = make_grad_and_apply(loss_fn, cfg, optimizer)

    def step_fn(model: nn.Module, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None, **draws) -> Metrics:
        metrics = grad_fn(model, batch, generator, **draws)
        metrics["grad_norm"] = apply_fn()
        return metrics

    return step_fn


def parse_target_modules(spec: Optional[str]) -> Tuple[str, ...]:
    """A reference-style ``--target_modules`` string onto the projection
    names (``parse_target_modules``, train_step.py:326): '' / 'none' -> ();
    'default' -> every attention and feed-forward projection; otherwise the
    names found in the string (``to_q``, ``to_k``, ``to_v``, ``to_out``,
    ``ff.net.0.proj`` / ``net_0``, ``ff.net.2`` / ``net_2``)."""
    if spec in (None, "", "none"):
        return ()
    if spec == "default":
        return DEFAULT_TARGETS
    atoms = {"to_q": "to_q", "to_k": "to_k", "to_v": "to_v", "to_out": "to_out",
             "ff.net.0.proj": "net_0", "net_0": "net_0", "ff.net.2": "net_2", "net_2": "net_2"}
    found = sorted({name for pat, name in atoms.items() if pat in spec})
    if not found:
        raise ValueError(f"no recognized projection names in target_modules {spec!r}")
    return tuple(found)


def install_lora(model: nn.Module, *, rank: int = 64, alpha: float = 64.0,
                 targets: Optional[Sequence[str]] = None, mot_only: bool = False,
                 generator: Optional[torch.Generator] = None) -> LoRATree:
    """The init of ``make_lora_sft_step`` (train_step.py:346): freezes every
    parameter of ``model``, draws the adapters (``init_lora``) and installs
    them (``apply_lora``); only they train. ``targets`` None means the
    defaults; an empty selection raises, as in JAX."""
    if targets is None:
        targets = DEFAULT_TARGETS
    elif not targets:
        raise ValueError(
            "LoRA training with no target modules: --target_modules 'none' "
            "selects nothing to train; pass 'default' or an explicit regex")
    model.requires_grad_(False)
    return apply_lora(model, init_lora(model, rank, targets, mot_only, generator),
                      alpha=alpha, rank=rank)


def make_lora_sft_step(loss_fn: LossFn, cfg, model: nn.Module,
                       make_optimizer: Callable[[Any], Optimizer], *,
                       generator: Optional[torch.Generator] = None, **lora_kw):
    """LoRA SFT (``make_lora_sft_step``, train_step.py:346): ``install_lora``
    on ``model`` (``lora_kw``: rank, alpha, targets, mot_only), the
    optimizer ``make_optimizer(params)`` over the adapters alone and
    ``make_train_step`` on it. Returns (lora, optimizer, step_fn); the
    trainer builds ``make_grad_and_apply`` on the same optimizer instead,
    for gradient accumulation."""
    lora = install_lora(model, generator=generator, **lora_kw)
    optimizer = make_optimizer(lora_parameters(lora))
    return lora, optimizer, make_train_step(cfg, optimizer, loss_fn)
