"""The control trainer (Wan): channel-concatenated control conditioning.

Port of the Wan half of ``vap_tpu/training/control_trainer.py`` (the
reference's ControlTrainer and WanControlModelSpecification). The
transformer's input layer is widened to take [noisy ‖ control (‖ mask)]
latents along channels (``expand_patch_embedding``: the new inputs start at
zero, so training starts at the unconditioned function); the control video
(canny edges, a copy of the clip, or a custom column: ``ControlDatasetWrapper``)
is VAE-encoded beside the target (``control_specs.WanControlSpec``), and
the frame conditioning keeps some of its frames:

  * ``apply_frame_conditioning_on_latents`` (:62): ``index`` keeps frame
    ``frame_conditioning_index`` (clamped), ``prefix`` the first n frames,
    ``random`` n frames at random (n uniform in [1, F] per sample, the draws
    from the step's ``torch.Generator``; JAX draws them from the step key),
    ``first_and_last``, ``full`` every frame; the others are zeroed, and
    with ``frame_conditioning_concatenate_mask`` one 0/1 mask channel is
    appended (in_channels 2C + 1, ``control_in_channels`` :105; JAX's
    documented reading of the reference, whose training path would take C
    mask channels);
  * ``wan_control_loss`` (:115-166): Wan's flow-matching loss over that
    input, the sigmas, the noise and the frame draws in that order;
  * ``control_lora``: LoRA adapters on the blocks' ``to_q``, ``to_k``,
    ``to_v``, ``to_out``, ``net_0``, ``net_2`` (``CONTROL_LORA_TARGETS``)
    plus, trained directly, the widened injection weight (its bias stays
    frozen) and, with ``train_qk_norm``, the QK norms' weights
    (``control_direct_names``, JAX's ``_control_direct_mask`` :238);
    ``control_full_finetune``: every parameter (``make_control_step``
    :254);
  * ``ControlTrainer`` (:335-487): the SFT loop with the control dataset
    wrapper, the control latents, the frame draws, control validation
    (FlowMatch Euler at shift 3, CFG 5.0, [x ‖ control] at every step,
    under the run's frame-conditioning settings, which JAX's trainer does
    not pass on) and the control export: under ``control_lora`` the
    adapters in PEFT layout plus ``control_injection_layers.safetensors``
    (the directly trained tensors in diffusers names and layout; JAX's file
    carries its own stacked tree names), under ``control_full_finetune``
    the whole transformer.

CogView4's control half raises NotImplementedError: the CogView4 family
(and GLM) is a later slice of the port.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..data import video as _video
from ..data.dataloader import PrefetchingDataLoader
from .args import CONTROL_MODEL_NAMES, FRAME_CONDITIONING_TYPES
from .checkpoint import export_control_layers, export_lora_safetensors, export_safetensors
from .layerwise import compute_dtype
from .lora import LoRATree, apply_lora, init_lora, lora_parameters, merge_lora_into_params
from .train_step import Metrics, _flow_match, draw_step_noise, make_grad_and_apply
from .trainer import SFTTrainer, step_generator

CONTROL_INJECTION_PATH = {"wan": "patch_embedding", "cogview4": "patch_embed.proj"}
# the reference's target_modules regex (transformer_blocks|single_transformer_blocks)
# .*(to_q|to_k|to_v|to_out.0|ff.net.0.proj|ff.net.2)
CONTROL_LORA_TARGETS = ("to_q", "to_k", "to_v", "to_out", "net_0", "net_2")
QK_NORMS = ("norm_q", "norm_k", "norm_added_k")
COGVIEW4_REFUSAL = ("control training of cogview4 is not ported: the CogView4 family and GLM "
                    "are a later slice (ROADMAP Queue 1 #7)")


def frame_keep_mask(batch: int, frames: int, frame_conditioning_type: str = "full",
                    frame_conditioning_index: int = 0,
                    generator: Optional[torch.Generator] = None, device=None) -> torch.Tensor:
    """The frames the control keeps, bool [B, F]; ``prefix`` draws n in
    [1, F] per sample, ``random`` n and then a uniform score per frame
    (keeping the n lowest), from ``generator``."""
    if frame_conditioning_type not in FRAME_CONDITIONING_TYPES:
        raise ValueError(f"unknown frame_conditioning_type {frame_conditioning_type!r}; "
                         f"valid: {FRAME_CONDITIONING_TYPES}")
    idx = torch.arange(frames, device=device)[None]
    if frame_conditioning_type == "index":
        keep = idx == min(frame_conditioning_index, frames - 1)
    elif frame_conditioning_type in ("prefix", "random"):
        n = torch.randint(1, frames + 1, (batch, 1), generator=generator, device=device)
        if frame_conditioning_type == "prefix":
            keep = idx < n
        else:
            scores = torch.rand((batch, frames), generator=generator, device=device)
            keep = torch.argsort(torch.argsort(scores, dim=1), dim=1) < n
    elif frame_conditioning_type == "first_and_last":
        keep = (idx == 0) | (idx == frames - 1)
    else:
        keep = torch.ones((1, frames), dtype=torch.bool, device=device)
    return keep.expand(batch, frames)


def apply_frame_conditioning_on_latents(control_latents: torch.Tensor,
                                        frame_conditioning_type: str = "full",
                                        frame_conditioning_index: int = 0,
                                        concatenate_mask: bool = False, *,
                                        generator: Optional[torch.Generator] = None,
                                        keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Zero the control frames not conditioned on (channel-last
    [B, F, H, W, C]); with ``concatenate_mask`` append one 0/1 channel
    marking the kept frames. ``keep`` [B, F] (``frame_keep_mask``, drawn
    from ``generator`` when not given)."""
    b, f = control_latents.shape[:2]
    if keep is None:
        keep = frame_keep_mask(b, f, frame_conditioning_type, frame_conditioning_index,
                               generator, control_latents.device)
    m = keep.to(control_latents.device, control_latents.dtype)[:, :, None, None, None]
    out = control_latents * m
    if concatenate_mask:
        out = torch.cat([out, m.expand(*control_latents.shape[:-1], 1)], dim=-1)
    return out


def control_in_channels(base_in_channels: int, concatenate_mask: bool = False) -> int:
    """in_channels of the widened input layer: 2C, + 1 with the mask."""
    return 2 * base_in_channels + (1 if concatenate_mask else 0)


@dataclasses.dataclass(frozen=True)
class WanControlTrainStepConfig:
    """JAX's ``WanControlTrainStepConfig``."""
    model: Any  # WanMOTConfig with the widened in_channels
    frame_conditioning_type: str = "full"
    frame_conditioning_index: int = 0
    frame_conditioning_concatenate_mask: bool = False
    num_train_timesteps: int = 1000
    flow_weighting_scheme: str = "none"
    flow_logit_mean: float = 0.0
    flow_logit_std: float = 1.0
    flow_mode_scale: float = 1.29
    remat: Union[bool, str] = True


def wan_control_loss(model: nn.Module, cfg: WanControlTrainStepConfig,
                     batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
                     *, sigmas: Optional[torch.Tensor] = None,
                     noise: Optional[torch.Tensor] = None,
                     keep: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Metrics]:
    """The flow-matching loss over [noisy ‖ frame-conditioned control]
    (``wan_control_loss``). batch, channel-last and normalised: ``latents``
    and ``control_latents`` [B, F, H, W, C], ``encoder_hidden_states``.
    ``sigmas`` [B], ``noise`` and ``keep`` [B, F] are drawn from
    ``generator`` in that order when not given."""
    latents = batch["latents"].float()
    timesteps, noisy, target, loss_w = _flow_match(cfg, latents, generator, sigmas, noise,
                                                   cfg.num_train_timesteps)
    control = apply_frame_conditioning_on_latents(
        batch["control_latents"].float(), cfg.frame_conditioning_type,
        cfg.frame_conditioning_index, cfg.frame_conditioning_concatenate_mask,
        generator=generator, keep=keep)
    hidden = torch.cat([noisy, control], dim=-1)
    dtype = compute_dtype(model)
    pred = model(hidden_states=hidden.to(dtype), timestep=timesteps,
                 encoder_hidden_states=batch["encoder_hidden_states"].to(dtype),
                 remat=cfg.remat)
    loss = torch.mean(loss_w * torch.square(pred.float() - target))
    return loss, {"loss": loss.detach()}


def control_direct_names(model: nn.Module, family: str = "wan",
                         train_qk_norm: bool = False) -> List[str]:
    """The parameters control LoRA trains directly (``_control_direct_mask``):
    the widened injection layer's weight (its bias stays frozen) and, with
    ``train_qk_norm``, the weights of the QK norms."""
    injection = CONTROL_INJECTION_PATH[family] + ".weight"
    return [n for n, _ in model.named_parameters()
            if n == injection or (train_qk_norm and any(q in n.split(".") for q in QK_NORMS))]


def make_control_step(loss_fn, cfg, model: nn.Module, make_optimizer, *, family: str,
                      full_finetune: bool = False, lora_rank: int = 64, lora_alpha: float = 64.0,
                      train_qk_norm: bool = False, generator: Optional[torch.Generator] = None):
    """Control training's trainables, optimizer and grad/apply pair
    (``make_control_step``): under ``full_finetune`` every parameter;
    otherwise adapters on ``CONTROL_LORA_TARGETS`` (drawn from
    ``generator``, installed in place) and the ``control_direct_names``,
    the rest frozen. Returns (the adapter tree or None, the optimizer,
    grad_fn, apply_fn)."""
    if family not in CONTROL_MODEL_NAMES:
        if family == "cogview4":
            raise NotImplementedError(COGVIEW4_REFUSAL)
        raise ValueError(f"control training supports {list(CONTROL_MODEL_NAMES)} (and cogview4, "
                         f"not ported), got {family!r}")
    lora = None
    if full_finetune:
        model.requires_grad_(True)
        params = list(model.parameters())
    else:
        model.requires_grad_(False)
        lora = apply_lora(model, init_lora(model, lora_rank, CONTROL_LORA_TARGETS,
                                           mot_only=False, generator=generator),
                          alpha=lora_alpha, rank=lora_rank)
        named = dict(model.named_parameters())
        direct = [named[n].requires_grad_(True)
                  for n in control_direct_names(model, family, train_qk_norm)]
        params = list(lora_parameters(lora)) + direct
    optimizer = make_optimizer(params)
    grad_fn, apply_fn = make_grad_and_apply(loss_fn, cfg, optimizer)
    return lora, optimizer, grad_fn, apply_fn


def merge_control_params(model: nn.Module, lora: Optional[LoRATree], *, lora_alpha: float,
                         lora_rank: int) -> Dict[str, torch.Tensor]:
    """The trained model as one state dict (``merge_control_params``): the
    adapters baked into their weights (the directly trained ones are the
    model's own)."""
    state = {k: v.detach() for k, v in model.state_dict().items()}
    if lora is None:
        return state
    return merge_lora_into_params(state, lora, alpha=lora_alpha, rank=lora_rank)


def _make_control_step_cfg(family: str, args, transformer_cfg) -> WanControlTrainStepConfig:
    if family == "cogview4":
        raise NotImplementedError(COGVIEW4_REFUSAL)
    return WanControlTrainStepConfig(
        model=transformer_cfg, frame_conditioning_type=args.frame_conditioning_type,
        frame_conditioning_index=args.frame_conditioning_index,
        frame_conditioning_concatenate_mask=args.frame_conditioning_concatenate_mask,
        remat=args.remat_mode(), flow_weighting_scheme=args.flow_weighting_scheme,
        flow_logit_mean=args.flow_logit_mean, flow_logit_std=args.flow_logit_std)


def _resolve(path: str, *roots: Optional[str]) -> str:
    """``path`` as given, else under the first of ``roots`` that has it."""
    if os.path.isabs(path) or os.path.exists(path):
        return path
    for root in roots:
        if root and os.path.exists(os.path.join(root, path)):
            return os.path.join(root, path)
    return path


class ControlTrainer(SFTTrainer):
    """The SFT loop (data, online or precomputed encodes, accumulation,
    checkpoints and resume, validation cadence, logging) with the control
    dataset wrapper, the control step and draws, control validation and the
    control export. The model given is the widened one
    (``expand_patch_embedding``)."""

    def __init__(self, args, model: nn.Module, spec=None, **kw):
        if not args.is_control:
            raise ValueError(f"ControlTrainer trains control_lora or control_full_finetune, "
                             f"got training_type {args.training_type!r}")
        if args.is_dpo:
            raise ValueError("DPO is not a control training type")
        super().__init__(args, model, spec, **kw)

    def _make_step_config(self):
        return _make_control_step_cfg(self.args.model_name, self.args, self.model.config)

    def _build_step(self) -> None:
        args, model = self.args, self.model
        self.full_finetune = args.training_type == "control_full_finetune"
        self.layerwise_cast = []
        self.lora, self.optimizer, self._grad, self._apply = make_control_step(
            wan_control_loss, self.step_cfg, model, self._make_optimizer,
            family=args.model_name, full_finetune=self.full_finetune, lora_rank=args.rank,
            lora_alpha=float(args.lora_alpha), train_qk_norm=args.train_qk_norm,
            generator=torch.Generator(device=self.device).manual_seed(args.seed))
        self.lora_mode = self.lora is not None
        self.trainable_names = [n for n, p in model.named_parameters() if p.requires_grad]

    def _draws(self, batch: Dict[str, torch.Tensor], step: int) -> Dict[str, torch.Tensor]:
        """As ``wan_control_loss`` makes them: the sigmas and the noise
        (``draw_step_noise``), then the frames kept, from the step's
        generator."""
        shape, gen = batch["latents"].shape, step_generator(self.args.seed, step, self.device)
        draws = draw_step_noise(self.step_cfg, shape, gen, self.device)
        cfg = self.step_cfg
        draws["keep"] = frame_keep_mask(shape[0], shape[1], cfg.frame_conditioning_type,
                                        cfg.frame_conditioning_index, gen, self.device)
        return draws

    def _prepare_dataset(self) -> PrefetchingDataLoader:
        """The plain video stream (``--dataset_config`` or ``--data_root``),
        each sample given its control (``ControlDatasetWrapper``)."""
        from ..data.generic import (ControlDatasetWrapper, DatasetPreprocessingWrapper,
                                    initialize_dataset)

        args = self.args
        if args.dataset_config:
            from ..data.config import build_datasets_from_config

            dataset = build_datasets_from_config(args.dataset_config, args,
                                                 family=args.model_name)
        else:
            dataset = DatasetPreprocessingWrapper(
                initialize_dataset(args.data_root, "video", infinite=True),
                id_token=args.id_token,
                remove_common_llm_caption_prefixes=args.remove_common_llm_caption_prefixes)
        return PrefetchingDataLoader(ControlDatasetWrapper(dataset, args.control_type),
                                     prefetch=4)

    def _fit(self, sample: Dict[str, Any]) -> Dict[str, Any]:
        """The clip and its control video each fitted to the buckets
        (JAX's ``_preprocess``)."""
        buckets = sample.get("_resolution_buckets", self.args.video_resolution_buckets)
        fsel = sample.get("_frames_selection", "evenly")
        out = dict(sample, video=_video.resize_to_nearest_bucket(sample["video"], buckets,
                                                                 fsel)[0])
        if "control_video" in sample:
            out["control_video"] = _video.resize_to_nearest_bucket(sample["control_video"],
                                                                   buckets, fsel)[0]
        return out

    def merged_params(self) -> Dict[str, torch.Tensor]:
        return merge_control_params(self.model, self.lora, lora_alpha=float(self.args.lora_alpha),
                                    lora_rank=self.args.rank)

    def export(self, path: Optional[str] = None) -> str:
        """Under ``control_full_finetune`` the whole transformer
        (``model.safetensors``); under ``control_lora`` the adapters in PEFT
        layout (``pytorch_lora_weights.safetensors``, returned) and the
        directly trained tensors as ``transformer.<name>``
        (``control_injection_layers.safetensors``), in
        ``<output_dir>/model_weights/<step:06d>/`` unless ``path`` (a
        directory) is given. Only rank 0 writes."""
        out_dir = path or os.path.join(self.args.output_dir, "model_weights",
                                       f"{self.train_state.step:06d}")
        target = os.path.join(out_dir, "model.safetensors" if self.full_finetune
                              else "pytorch_lora_weights.safetensors")
        if self.rank != 0:  # rank 0 writes
            return target
        if self.full_finetune:
            export_safetensors(self.merged_params(), target)
            return target
        export_lora_safetensors(self.lora, target, rank=self.args.rank,
                                alpha=float(self.args.lora_alpha))
        params = dict(self.model.named_parameters())
        export_control_layers({n: params[n] for n in control_direct_names(
            self.model, self.args.model_name, self.args.train_qk_norm)},
            os.path.join(out_dir, "control_injection_layers.safetensors"))
        return target

    def _validate(self) -> None:
        """Control validation (JAX's ``_validate``): every entry of the
        validation JSON's ``data`` (a caption and a ``control_video`` path
        or array; else the canny edges of its ``video``) sampled with the
        live model at the entry's ``num_inference_steps`` (30) and the
        run's seed and frame conditioning, written as
        ``validation/<step:06d>/sample_<i>.mp4``."""
        args = self.args
        if self.spec is None:
            raise ValueError("validation needs a spec (the encoders and the VAE)")
        with open(args.validation_dataset_file) as f:
            val = json.load(f)
        data = val.get("data", []) if isinstance(val, dict) else val
        roots = (os.path.dirname(os.path.abspath(args.validation_dataset_file)), args.data_root)
        model = self.model
        if self.train_state.step % self.accum_steps == 0:
            for p in model.parameters():
                p.grad = None
        was_training = model.training
        reload = bool(self._host_encoders)
        if reload:
            self._load_encoders()
        model.eval()
        try:
            with torch.no_grad():
                out_dir = os.path.join(args.output_dir, "validation",
                                       f"{self.train_state.step:06d}")
                if self.rank == 0:
                    os.makedirs(out_dir, exist_ok=True)
                artifacts: Dict[str, str] = {}
                for i, sample in enumerate(data):
                    sample = dict(sample)
                    for key in ("control_video", "video"):
                        if isinstance(sample.get(key), str):
                            sample[key] = _resolve(sample[key], *roots)
                    with self._attn_ctx(training=False):
                        media = self.spec.validation(
                            sample, num_inference_steps=sample.get("num_inference_steps", 30),
                            seed=args.seed, frame_conditioning_type=args.frame_conditioning_type,
                            frame_conditioning_index=args.frame_conditioning_index,
                            concatenate_mask=args.frame_conditioning_concatenate_mask)
                    if self.rank == 0:
                        self._write_validation_sample(np.asarray(media), out_dir, i, artifacts)
                if self.rank == 0:
                    self.tracker.log_artifacts(artifacts, step=self.train_state.step)
                    self.validation_artifacts = artifacts
        finally:
            model.train(was_training)
            if reload:
                self._offload_encoders()

