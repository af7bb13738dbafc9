"""The Video-As-Prompt training objectives in PyTorch: the CogVideoX VAP
loss in every mode, the Wan and HunyuanVideo flow-matching losses, LoRA SFT
and DPO.

Port of ``vap_tpu/training/train_step.py``. The CogVideoX loss
(``cogvideox_vap_loss``, :158-292):
  * a uniform timestep and Gaussian noise per sample; ``add_noise`` on the
    target latents under the zero-terminal-SNR table;
  * the model input is [noisy ‖ image latents] (channels), and the
    reference branch gets [reference latents ‖ its image latents];
  * pred = get_velocity(ᾱ, velocity, noisy, t), the x0 prediction, against
    the clean latents, weighted by 1 / (1 - ᾱ_t) (1 at t = 999, where
    ᾱ = 0; above 1e3 at small t), in float32;
  * without ``latents_mot_ref`` in the batch, the plain loss: the trunk
    alone over [noisy ‖ image latents] (I2V) or the noisy latents (T2V);
  * ``reference_independent``: each reference noised at its own timestep in
    [0, ``num_ref_diffusion_time_sigmas``), its own head's x0 prediction
    against the clean reference, weighted the same way, added at
    0.6 / ``sample_ref_videos_num``; the reference timesteps reach the
    reference branch's time embedding only under ``random_refer_noise``;
  * ``ablation_single_branch``: the trunk alone over [target ‖ references]
    along frames with the two RoPE tables concatenated (the target alone
    under ``baseline_single_condition``), the loss on the first frames;
  * CogVideoX 1.5 (``patch_size_t``): the slice RoPE grid;
  * only the MoT expert trains under ``video_as_prompt_mot``: every
    parameter whose name has no ``TRAINABLE_MARKERS`` entry gets
    ``requires_grad_(False)``. Activation gradients still flow through the
    frozen trunk, whose weights get none.

The Wan loss (``wan_vap_loss``, :530): sigmas drawn by the flow-matching
density of ``flow_weighting_scheme`` on the FlowMatch training grid, x_t =
(1 - sigma) x0 + sigma n, the target n - x0, the loss weighted per sample by
``flow_loss_weights``; the plain branch (no reference in the batch: the
trunk alone, T2V without conditioning channels) and the MoT branch (clean
references at t = 1).

The HunyuanVideo loss (``hunyuan_loss``, :770): the same flow matching on
channel-first [B, C, F, H, W] latents, with the timestep sigma * 1000, the
distilled guidance fixed at 1.0 * 1000 and the text mask as the model's
``encoder_attention_mask`` (so its joint attention runs K7, forward and
backward).

LoRA SFT (``make_lora_sft_step``, :346): adapters over the targeted
projections of a frozen model (``training/lora.py``); only they train.

DPO (``_make_dpo_step_from``, :474; ``make_dpo_step`` :516,
``make_wan_dpo_step`` :669): a batch of win rows then lose rows; per-sample
losses (``cogvideox_per_sample_loss``, ``wan_per_sample_loss``) where win
and lose share one timestep (sigma) and one noise draw; the reference pass
runs the same model with its adapters bypassed, under ``no_grad``, on the
same draws as the policy pass; the loss is
-logsigmoid(-0.5 beta ((w - l)_policy - (w - l)_reference)) * dpo_weight,
meaned over pairs.

Timesteps, sigmas and noise come from a ``torch.Generator``, or are given
explicitly (the tests pass JAX's draws).
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
from .layerwise import compute_dtype
from .lora import (DEFAULT_TARGETS, LoRATree, apply_lora, init_lora, lora_bypassed,
                   lora_parameters)
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
    """The JAX ``TrainStepConfig`` (train_step.py:96-111)."""
    model: CogVideoXMOTConfig
    reference_train_mode: Optional[str] = None   # None | "reference_independent"
    random_refer_noise: bool = False
    num_ref_diffusion_time_sigmas: int = 10
    sample_ref_videos_num: int = 1
    ref_type: str = "continous_negative"
    num_train_timesteps: int = 1000
    remat: Union[bool, str] = True
    # one trunk over [target ‖ refs] with concatenated RoPE, the loss on the
    # target's frames; with baseline_single_condition the refs are dropped
    ablation_single_branch: bool = False
    baseline_single_condition: bool = False


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
    """The target's RoPE table and the references' (``mot_num`` of them);
    with ``patch_size_t`` (CogVideoX 1.5) the slice grid."""
    kw = dict(attention_head_dim=cfg.attention_head_dim, patch_size=cfg.patch_size,
              patch_size_t=cfg.patch_size_t, sample_width=cfg.sample_width,
              sample_height=cfg.sample_height, device=device)
    rope = prepare_cogvideox_rotary_embeddings(lat_h * 8, lat_w * 8, lat_f, **kw)
    if not mot_num:
        return rope, None
    rope_ref = prepare_cogvideox_rotary_embeddings(lat_h * 8, lat_w * 8, lat_f, mot_num=mot_num,
                                                   ref_type=ref_type, **kw)
    return rope, rope_ref


def _alphas_cumprod(device) -> torch.Tensor:
    return torch.from_numpy(make_alphas_cumprod(rescale_betas_zero_snr=True)).to(device)


def _x0_error(alphas_cumprod: torch.Tensor, velocity: torch.Tensor, noisy: torch.Tensor,
              timesteps: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The weighted squared error of the x0 prediction, elementwise:
    1 / (1 - ᾱ_t) (get_velocity(ᾱ, velocity, noisy, t) - target)^2."""
    pred = get_velocity(alphas_cumprod, velocity.float(), noisy, timesteps)
    weights = (1.0 / (1.0 - alphas_cumprod[timesteps])).reshape(-1, 1, 1, 1, 1)
    return weights * torch.square(pred - target)


def _cogvideox_velocity(model: nn.Module, cfg: TrainStepConfig, batch: Dict[str, torch.Tensor],
                        noisy: torch.Tensor, timesteps: torch.Tensor,
                        ref_in: Optional[torch.Tensor] = None,
                        t_ref: Optional[torch.Tensor] = None,
                        effect_ids: Optional[torch.Tensor] = None,
                        reference_head: bool = False, single_branch: bool = False
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The CogVideoX model on the noisy target latents [B, F, C, H, W],
    each beside its image latents where the batch has them. Returns (the
    velocity, the reference head's under ``reference_head``, else None):
      * ``ref_in`` None: the trunk alone (I2V or T2V);
      * ``single_branch`` (``ablation_single_branch``): the trunk alone over [target ‖
        references] along frames with the two RoPE tables concatenated (the
        target alone under ``baseline_single_condition``), cut to the
        target's frames;
      * else the MoT branch over the references ``ref_in`` [B, R*F, C, H, W]
        at ``t_ref`` [B, R] (the target's timestep when None)."""
    f_lat, lat_h, lat_w = noisy.shape[1], noisy.shape[3], noisy.shape[4]
    dtype = compute_dtype(model)
    text = batch["encoder_hidden_states"].to(dtype)
    hidden = noisy
    if "image_latents" in batch:
        hidden = torch.cat([noisy, batch["image_latents"].float()], dim=2)
    num_mot_ref = 0 if ref_in is None else ref_in.shape[1] // f_lat
    rope, rope_ref = _rope_tables(cfg.model, lat_h, lat_w, f_lat, num_mot_ref, cfg.ref_type,
                                  noisy.device)
    if ref_in is None:
        return model(hidden.to(dtype), text, timesteps.float(), rope, remat=cfg.remat), None
    hidden_ref = torch.cat([ref_in, batch["image_latents_mot_ref"].float()], dim=2)
    if single_branch:
        if not cfg.baseline_single_condition:
            hidden = torch.cat([hidden, hidden_ref], dim=1)
            rope = (torch.cat([rope[0], rope_ref[0]]), torch.cat([rope[1], rope_ref[1]]))
        return model(hidden.to(dtype), text, timesteps.float(), rope,
                     remat=cfg.remat)[:, :f_lat], None
    carry, aux = model.prologue(hidden.to(dtype), text, timesteps.float(), rope,
                                hidden_ref.to(dtype),
                                batch["encoder_hidden_states_mot_ref"].to(dtype), rope_ref,
                                num_mot_ref, t_ref, effect_ids)
    return model.epilogue(model.run_blocks(carry, aux, cfg.remat), aux,
                          reference_head=reference_head)


def cogvideox_vap_loss(model: nn.Module, cfg: TrainStepConfig, batch: Dict[str, torch.Tensor],
                       generator: Optional[torch.Generator] = None, *,
                       timesteps: Optional[torch.Tensor] = None,
                       noise: Optional[torch.Tensor] = None,
                       ref_timesteps: Optional[torch.Tensor] = None,
                       ref_noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Metrics]:
    """The loss of ``cogvideox_vap_loss`` (train_step.py:158-292), every
    branch. batch: ``latents`` [B, F, C, H, W], ``encoder_hidden_states``
    [B, T, Dt], optionally ``image_latents`` [B, F, C, H, W] (VAE scaled);
    with references ``latents_mot_ref``, ``image_latents_mot_ref``
    [B, R*F, C, H, W], ``encoder_hidden_states_mot_ref`` [B, R*T, Dt] and
    optionally ``effect_ids`` [R]; on the model's device. ``timesteps`` [B]
    and ``noise`` (the latents' shape), and under ``reference_independent``
    ``ref_timesteps`` [B, R] and ``ref_noise`` (the references' shape), are
    drawn from ``generator`` in that order when not given."""
    latents = batch["latents"].float()
    b, f_lat, c, lat_h, lat_w = latents.shape
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

    if "latents_mot_ref" not in batch:
        # the plain finetune: the trunk alone, I2V with first-frame image
        # latents, else T2V
        velocity, _ = _cogvideox_velocity(model, cfg, batch, noisy, timesteps)
        loss = torch.mean(_x0_error(alphas_cumprod, velocity, noisy, timesteps, latents))
        return loss, {"loss": loss.detach(), "loss_main": loss.detach()}

    latents_ref = batch["latents_mot_ref"].float()
    num_mot_ref = latents_ref.shape[1] // f_lat
    per_ref = (b * num_mot_ref, f_lat, c, lat_h, lat_w)
    independent = cfg.reference_train_mode == "reference_independent"
    if independent:  # each reference noised at one of the last timesteps
        if ref_timesteps is None:
            ref_timesteps = torch.randint(0, cfg.num_ref_diffusion_time_sigmas, (b, num_mot_ref),
                                          generator=generator, device=device)
        if ref_noise is None:
            ref_noise = torch.randn(latents_ref.shape, generator=generator, device=device,
                                    dtype=torch.float32)
        ref_timesteps = ref_timesteps.to(device)
        ref_in = add_noise(alphas_cumprod, latents_ref.reshape(per_ref),
                           ref_noise.to(device, torch.float32).reshape(per_ref),
                           ref_timesteps.reshape(-1)).reshape(latents_ref.shape)
    else:
        ref_in = latents_ref
    t_ref = ref_timesteps.float() if independent and cfg.random_refer_noise else None
    velocity, velocity_ref = _cogvideox_velocity(model, cfg, batch, noisy, timesteps, ref_in,
                                                 t_ref, batch.get("effect_ids"),
                                                 reference_head=independent,
                                                 single_branch=cfg.ablation_single_branch)
    loss_main = torch.mean(_x0_error(alphas_cumprod, velocity, noisy, timesteps, latents))
    metrics = {"loss_main": loss_main.detach()}
    loss = loss_main
    if independent:
        if velocity_ref is None:
            raise ValueError("reference_independent needs the reference head: a MoT model "
                             "whose config has reference_train_mode='reference_independent', "
                             "without ablation_single_branch")
        loss_ref = torch.mean(_x0_error(alphas_cumprod, velocity_ref.reshape(per_ref),
                                        ref_in.reshape(per_ref), ref_timesteps.reshape(-1),
                                        latents_ref.reshape(per_ref)))
        loss_ref = loss_ref * 0.6 / cfg.sample_ref_videos_num
        metrics["loss_ref"] = loss_ref.detach()
        loss = loss + loss_ref
    metrics["loss"] = loss.detach()
    return loss, metrics


def _pair_draws(draws: Dict[str, Optional[torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Each draw of a pair [P, ...] repeated for its win and lose rows
    [2P, ...] (win rows first)."""
    return {k: torch.cat([v, v]) for k, v in draws.items()}


def cogvideox_per_sample_loss(model: nn.Module, cfg: TrainStepConfig,
                              batch: Dict[str, torch.Tensor],
                              generator: Optional[torch.Generator] = None, *,
                              timesteps: Optional[torch.Tensor] = None,
                              noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The per-sample weighted x0 loss of DPO (``_per_sample_weighted_mse``,
    train_step.py:431), [2P] for a batch of P win rows then P lose rows
    (the VAP keys of ``cogvideox_vap_loss``, clean references). A pair
    shares ``timesteps`` [P] and ``noise`` [P, F, C, H, W], drawn from
    ``generator`` in that order when not given."""
    latents = batch["latents"].float()
    device = latents.device
    if timesteps is None or noise is None:
        drawn = draw_step_noise(cfg, (latents.shape[0] // 2,) + tuple(latents.shape[1:]),
                                generator, device)
        timesteps = drawn["timesteps"] if timesteps is None else timesteps
        noise = drawn["noise"] if noise is None else noise
    pair = _pair_draws({"t": timesteps.to(device), "n": noise.to(device, torch.float32)})
    alphas_cumprod = _alphas_cumprod(device)
    noisy = add_noise(alphas_cumprod, latents, pair["n"], pair["t"])
    # the MoT branch over clean references, without effect ids, whatever
    # the ablation flags, as in JAX
    velocity, _ = _cogvideox_velocity(model, cfg, batch, noisy, pair["t"],
                                      batch["latents_mot_ref"].float())
    err = _x0_error(alphas_cumprod, velocity, noisy, pair["t"], latents)
    return err.mean(dim=(1, 2, 3, 4))


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


def _flow_match(cfg, latents: torch.Tensor, generator: Optional[torch.Generator],
                sigmas: Optional[torch.Tensor], noise: Optional[torch.Tensor],
                num_train_timesteps: int = 1000):
    """The flow-matching draws shared by the Wan and Hunyuan losses, for
    float32 ``latents`` in either layout: sigmas [B] (``sample_flow_sigmas``
    by ``cfg``'s flow flags) and float32 noise, each drawn from ``generator``
    when not given. Returns (timesteps = sigma * num_train_timesteps, x_t =
    (1 - sigma) x0 + sigma n, the target n - x0, the flow loss weights
    broadcast to the latents' rank)."""
    b, device = latents.shape[0], latents.device
    if sigmas is None:
        sigmas = sample_flow_sigmas(b, scheme=cfg.flow_weighting_scheme,
                                    logit_mean=cfg.flow_logit_mean, logit_std=cfg.flow_logit_std,
                                    mode_scale=cfg.flow_mode_scale,
                                    num_train_timesteps=num_train_timesteps,
                                    generator=generator, device=device)
    if noise is None:
        noise = torch.randn(latents.shape, generator=generator, device=device,
                            dtype=torch.float32)
    sigmas, noise = sigmas.to(device, torch.float32), noise.to(device, torch.float32)
    s = sigmas.reshape((b,) + (1,) * (latents.ndim - 1))
    noisy = (1.0 - s) * latents + s * noise  # flow_match_xt
    loss_w = flow_loss_weights(sigmas, cfg.flow_weighting_scheme).reshape(s.shape)
    return sigmas * num_train_timesteps, noisy, noise - latents, loss_w


def _wan_velocity(model: nn.Module, batch: Dict[str, torch.Tensor], noisy: torch.Tensor,
                  timesteps: torch.Tensor, remat) -> torch.Tensor:
    """The Wan model on the noisy latents and the batch's conditioning: the
    trunk alone without ``latents_mot_ref`` (``condition`` concatenated
    where present), else the MoT branch with clean references at t = 1."""
    b, f_lat = noisy.shape[:2]
    dtype = compute_dtype(model)

    def states(name):
        x = batch.get(name)
        return None if x is None else x.to(dtype)

    hidden = noisy
    if "condition" in batch:
        hidden = torch.cat([noisy, batch["condition"].float()], dim=-1)
    kwargs = dict(hidden_states=hidden.to(dtype), timestep=timesteps,
                  encoder_hidden_states=states("encoder_hidden_states"),
                  encoder_hidden_states_image=states("encoder_hidden_states_image"),
                  remat=remat)
    if "latents_mot_ref" in batch:
        latents_ref = batch["latents_mot_ref"].float()
        num_mot_ref = latents_ref.shape[1] // f_lat
        hidden_ref = torch.cat([latents_ref, batch["condition_mot_ref"].float()], dim=-1)
        kwargs.update(hidden_states_mot_ref=hidden_ref.to(dtype),
                      timestep_mot_ref=torch.ones((b, num_mot_ref), device=noisy.device),
                      encoder_hidden_states_mot_ref=states("encoder_hidden_states_mot_ref"),
                      encoder_hidden_states_image_mot_ref=states(
                          "encoder_hidden_states_image_mot_ref"),
                      num_mot_ref=num_mot_ref)
    return model(**kwargs)


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
    timesteps, noisy, target, loss_w = _flow_match(cfg, latents, generator, sigmas, noise,
                                                   cfg.num_train_timesteps)
    velocity = _wan_velocity(model, batch, noisy, timesteps, cfg.remat)
    loss = torch.mean(loss_w * torch.square(velocity.float() - target))
    return loss, {"loss": loss.detach(), "loss_main": loss.detach()}


def wan_per_sample_loss(model: nn.Module, cfg: WanTrainStepConfig,
                        batch: Dict[str, torch.Tensor],
                        generator: Optional[torch.Generator] = None, *,
                        sigmas: Optional[torch.Tensor] = None,
                        noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The per-sample flow-matching loss of Wan DPO (``_wan_per_sample_mse``,
    train_step.py:619), [2P] for P win rows then P lose rows (the MoT keys
    of ``wan_vap_loss``). A pair shares ``sigmas`` [P] and ``noise``
    [P, F, H, W, C], drawn from ``generator`` in that order when not
    given."""
    latents = batch["latents"].float()
    if sigmas is None or noise is None:
        drawn = draw_step_noise(cfg, (latents.shape[0] // 2,) + tuple(latents.shape[1:]),
                                generator, latents.device)
        sigmas = drawn["sigmas"] if sigmas is None else sigmas
        noise = drawn["noise"] if noise is None else noise
    pair = _pair_draws({"s": sigmas.to(latents.device, torch.float32),
                        "n": noise.to(latents.device, torch.float32)})
    timesteps, noisy, target, loss_w = _flow_match(cfg, latents, None, pair["s"], pair["n"],
                                                   cfg.num_train_timesteps)
    velocity = _wan_velocity(model, batch, noisy, timesteps, cfg.remat)
    err = loss_w * torch.square(velocity.float() - target)
    return err.mean(dim=tuple(range(1, err.ndim)))


@dataclasses.dataclass(frozen=True)
class HunyuanTrainStepConfig:
    """The JAX ``HunyuanTrainStepConfig`` (train_step.py:759)."""
    model: Any  # HunyuanVideoConfig
    guidance: float = 1.0
    flow_weighting_scheme: str = "none"
    flow_logit_mean: float = 0.0
    flow_logit_std: float = 1.0
    flow_mode_scale: float = 1.29
    remat: Union[bool, str] = True


def hunyuan_loss(model: nn.Module, cfg: HunyuanTrainStepConfig, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None, *,
                 sigmas: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Metrics]:
    """The HunyuanVideo flow-matching loss of ``hunyuan_loss``
    (train_step.py:770-800). batch: ``latents`` [B, C, F, H, W] (VAE-scaled),
    ``encoder_hidden_states`` [B, S, text_embed_dim] (LLaMA),
    ``pooled_projections`` [B, P] (CLIP) and optionally
    ``prompt_attention_mask`` [B, S]. ``sigmas`` [B] and ``noise`` (the
    latents' shape) are drawn from ``generator`` when not given. The
    precomputed states go into the model in its dtype."""
    latents = batch["latents"].float()
    b = latents.shape[0]
    timesteps, noisy, target, loss_w = _flow_match(cfg, latents, generator, sigmas, noise)
    dtype = compute_dtype(model)
    pred = model(hidden_states=noisy.to(dtype),
                 encoder_hidden_states=batch["encoder_hidden_states"].to(dtype),
                 pooled_projections=batch["pooled_projections"].to(dtype),
                 timestep=timesteps,
                 guidance=torch.full((b,), cfg.guidance * 1000.0, device=latents.device),
                 encoder_attention_mask=batch.get("prompt_attention_mask"),
                 remat=cfg.remat)
    loss = torch.mean(loss_w * torch.square(pred.float() - target))
    return loss, {"loss": loss.detach()}


def draw_step_noise(cfg, latents_shape: Sequence[int], generator: torch.Generator,
                    device=None, ref_shape: Optional[Sequence[int]] = None
                    ) -> Dict[str, torch.Tensor]:
    """The random draws of one micro-batch, as the family's loss makes them
    from ``generator`` when it is given none, in the same order: CogVideoX
    (``TrainStepConfig``) ``timesteps`` [B] then ``noise``, and under
    ``reference_independent`` with ``ref_shape`` (the references' latents)
    ``ref_timesteps`` [B, R] then ``ref_noise``; the flow families
    ``sigmas`` [B] (``sample_flow_sigmas`` by ``cfg``'s flags) then
    ``noise``, of the latents' shape. The data-parallel trainer draws them
    for the whole global batch and gives each rank its rows; DPO draws them
    for the pairs (``latents_shape`` of the win rows)."""
    b = latents_shape[0]
    if isinstance(cfg, TrainStepConfig):
        draws = {"timesteps": torch.randint(0, cfg.num_train_timesteps, (b,), generator=generator,
                                            device=device)}
    else:
        draws = {"sigmas": sample_flow_sigmas(
            b, scheme=cfg.flow_weighting_scheme, logit_mean=cfg.flow_logit_mean,
            logit_std=cfg.flow_logit_std, mode_scale=cfg.flow_mode_scale,
            num_train_timesteps=getattr(cfg, "num_train_timesteps", 1000), generator=generator,
            device=device)}
    draws["noise"] = torch.randn(tuple(latents_shape), generator=generator, device=device,
                                 dtype=torch.float32)
    if (isinstance(cfg, TrainStepConfig) and cfg.reference_train_mode == "reference_independent"
            and ref_shape is not None):
        num_mot_ref = ref_shape[1] // latents_shape[1]
        draws["ref_timesteps"] = torch.randint(0, cfg.num_ref_diffusion_time_sigmas,
                                               (b, num_mot_ref), generator=generator,
                                               device=device)
        draws["ref_noise"] = torch.randn(tuple(ref_shape), generator=generator, device=device,
                                         dtype=torch.float32)
    return draws


PerSampleFn = Callable[..., torch.Tensor]
DPO_BETA = 500.0


def make_dpo_loss(per_sample_fn: PerSampleFn,
                  clock: Optional[Callable[[str], None]] = None):
    """The DPO loss of ``_make_dpo_step_from`` (train_step.py:474-513) over
    ``per_sample_fn`` (``cogvideox_per_sample_loss`` or
    ``wan_per_sample_loss``), as a loss function of ``make_grad_and_apply``:
    ``dpo_loss(model, cfg, batch, generator=None, **draws) -> (loss,
    metrics)``. batch: P win rows then P lose rows, and
    ``dpo_weight`` [P] (1 where absent). The pair draws (``timesteps`` or
    ``sigmas``, then ``noise``, [P, ...]) are drawn once from ``generator``
    when not given and serve both passes, as JAX's shared key does: first
    the reference, the model with its adapters bypassed under ``no_grad``
    (then ``clock("reference")`` where a clock is given), then the policy.
    The loss is mean(-logsigmoid(-0.5 DPO_BETA (model_diff - ref_diff))
    dpo_weight), with
    model_diff = win - lose of the policy's per-sample losses and ref_diff
    the reference's; the metrics hold both means, both passes' per-sample
    losses and the mean pair weight."""

    def dpo_loss(model: nn.Module, cfg, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None,
                 **draws: torch.Tensor) -> Tuple[torch.Tensor, Metrics]:
        latents = batch["latents"]
        half = latents.shape[0] // 2
        if len(draws) < 2:
            draws = {**draw_step_noise(cfg, (half,) + tuple(latents.shape[1:]), generator,
                                       latents.device), **draws}
        with torch.no_grad(), lora_bypassed(model):
            ref_losses = per_sample_fn(model, cfg, batch, **draws)
        if clock:
            clock("reference")
        losses = per_sample_fn(model, cfg, batch, **draws)
        ref_diff = ref_losses[:half] - ref_losses[half:]
        model_diff = losses[:half] - losses[half:]
        inside = -0.5 * DPO_BETA * (model_diff - ref_diff)
        dpo_w = batch.get("dpo_weight")
        dpo_w = torch.ones_like(model_diff) if dpo_w is None else dpo_w.float()
        loss = torch.mean(-torch.nn.functional.logsigmoid(inside) * dpo_w)
        return loss, {"loss": loss.detach(), "model_diff": model_diff.mean().detach(),
                      "ref_diff": ref_diff.mean(), "policy_losses": losses.detach(),
                      "ref_losses": ref_losses, "dpo_weight": dpo_w.mean()}

    return dpo_loss


DPO_PER_SAMPLE = {"cogvideox": cogvideox_per_sample_loss, "wan": wan_per_sample_loss}


def install_dpo_lora(model: nn.Module, *, rank: int = 64, alpha: float = 64.0,
                     generator: Optional[torch.Generator] = None) -> LoRATree:
    """The policy's adapters of DPO (``_make_dpo_step_from``'s init_fn,
    train_step.py:490-494): every default projection of the MoT expert
    (``DEFAULT_TARGETS``, ``mot_only``), whatever ``--target_modules``
    says; the base model, frozen, doubles as the DPO reference."""
    return install_lora(model, rank=rank, alpha=alpha, targets=DEFAULT_TARGETS, mot_only=True,
                        generator=generator)


def make_dpo_step(cfg, optimizer: Optimizer, family: str = "cogvideox"):
    """One DPO update (``make_dpo_step`` :516, ``make_wan_dpo_step`` :669):
    ``step_fn(model, batch, generator=None, **draws) -> metrics`` with
    ``grad_norm``, on a model whose adapters (``install_dpo_lora``) are what
    ``optimizer`` holds."""
    return make_train_step(cfg, optimizer, make_dpo_loss(DPO_PER_SAMPLE[family]))


def make_hunyuan_train_step(cfg: HunyuanTrainStepConfig, optimizer: Optimizer):
    """The full-finetune HunyuanVideo step (``make_hunyuan_train_step``,
    train_step.py:804): ``make_train_step`` on ``hunyuan_loss``. (LoRA:
    ``make_lora_sft_step(hunyuan_loss, ...)``, as the trainer does.)"""
    return make_train_step(cfg, optimizer, hunyuan_loss)


LossFn = Callable[..., Tuple[torch.Tensor, Metrics]]


def make_grad_and_apply(loss_fn: LossFn, cfg: TrainStepConfig, optimizer: Optimizer, *,
                        unreached_ok: bool = False):
    """The split step of ``make_grad_and_apply`` (train_step.py:295-323),
    for gradient accumulation.

    ``grad_fn(model, batch, generator=None, clock=None, **draws) -> metrics``
    adds this micro-batch's gradient into the trainable parameters' ``.grad``
    (their sum over micro-batches), calling ``clock("forward")`` once the
    loss is computed and ``clock("backward")`` once it is differentiated.
    A loss that nothing that trains reaches raises, unless ``unreached_ok``
    (``training_type sft`` on plain data, whose loss never reaches the MoT
    partition that trains): then the gradients stay zero, as in JAX.
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
        if loss.requires_grad:
            loss.backward()
        elif not unreached_ok:
            raise ValueError("nothing that trains reaches the loss: no trainable parameter "
                             "would get a gradient")
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
