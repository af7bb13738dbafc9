"""The port's SFT trainer for the Video-As-Prompt families (CogVideoX, Wan)
and HunyuanVideo.

Port of ``vap_tpu/training/trainer.py`` ``SFTTrainer`` (``_make_step_config``
:47, ``_build_step`` :191-235, ``_install_accum`` :252, ``run`` :458-602,
``_merged_params`` :605) on one device:
  * ``--training_type video_as_prompt_mot``: only the MoT expert trains
    (``trainable_mask``); ``lora``: adapters over the ``--target_modules``
    projections of the frozen model (``install_lora``). The optimizer
    holds only what trains;
  * the loss is the family's: ``cogvideox_vap_loss``, ``wan_vap_loss`` or
    ``hunyuan_loss`` (the flow-matching flags from the arguments);
  * the batches come from the precomputed ``.npz`` cache, replayed forever
    and bucketed by shape; the text encoder and the VAE never load;
  * ``train_state.step`` counts micro-batches; every
    ``gradient_accumulation_steps`` of them the summed gradients are
    averaged and take one optimizer update (trainer.py:548-558);
  * each micro-batch draws its timesteps (sigmas) and noise from a generator
    seeded from (seed, step), so a resumed run draws what an uninterrupted
    one draws (trainer.py:535-538); the LoRA adapters are drawn from
    ``seed``;
  * loss and grad_norm are logged every ``logging_steps`` and kept in
    ``history``, with the seconds of the forward, the backward and the
    update (the device is synchronised at each mark);
  * a checkpoint every ``checkpointing_steps`` holds what trains (the
    expert, or the adapters) and the optimizer state; ``resume_from_checkpoint``
    ("latest" or a step) restores them, the train state and the data
    position.

Not ported: validation sampling, DPO, the exports, the device mesh, the
profiler window and the trackers.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List

import numpy as np
import torch
from torch import nn

from ..data.precomputation import PrecomputedReader
from ..data.sampler import ResolutionSampler, collate_tensor_dicts
from .args import TrainingArgs
from .checkpoint import Checkpointer, TrainState
from .lora import lora_parameters, merge_lora_into_params
from .optimizer import get_lr_schedule, get_optimizer
from .train_step import (HunyuanTrainStepConfig, TrainStepConfig, WanTrainStepConfig,
                         cogvideox_vap_loss, hunyuan_loss, install_lora, make_grad_and_apply,
                         parse_target_modules, trainable_mask, wan_vap_loss)

logger = logging.getLogger("vap_tpu_torch.trainer")


FAMILY_LOSSES = {"cogvideox": cogvideox_vap_loss, "wan": wan_vap_loss,
                 "hunyuan_video": hunyuan_loss}
FLOW_STEP_CONFIGS = {"wan": WanTrainStepConfig, "hunyuan_video": HunyuanTrainStepConfig}


def _make_step_config(family: str, args: TrainingArgs, transformer_cfg):
    """The family's train-step config (trainer.py:47); the flow-matching
    flags go to the flow families, Wan and HunyuanVideo (CogVideoX trains
    under DDIM with uniform timesteps, as in JAX)."""
    if family in FLOW_STEP_CONFIGS:
        return FLOW_STEP_CONFIGS[family](model=transformer_cfg, remat=args.remat_mode(),
                                         flow_weighting_scheme=args.flow_weighting_scheme,
                                         flow_logit_mean=args.flow_logit_mean,
                                         flow_logit_std=args.flow_logit_std)
    return TrainStepConfig(model=transformer_cfg, remat=args.remat_mode())


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The generator of micro-batch ``step``: a function of (seed, step) only."""
    return torch.Generator(device=device).manual_seed((seed << 32) + step)


class SFTTrainer:
    def __init__(self, args: TrainingArgs, model: nn.Module):
        if not args.precomputation_dir:
            raise ValueError("the port trains from a precomputed cache: set precomputation_dir")
        self.args = args
        self.model = model
        self.device = next(model.parameters()).device
        self.step_cfg = _make_step_config(args.model_name, args, model.config)
        self.accum_steps = args.gradient_accumulation_steps
        self._build_step()
        self.train_state = TrainState()
        self.data_position = 0  # items taken from the endless replay of the cache
        self.checkpointer = Checkpointer(os.path.join(args.output_dir, "checkpoints"),
                                         args.checkpointing_limit)
        self.history: List[Dict[str, float]] = []

    def _build_step(self) -> None:
        """The optimizer and the grad/apply pair of this training type; what
        trains is ``trainable_names``, the adapters in ``lora`` (LoRA)."""
        args, model = self.args, self.model
        loss_fn = FAMILY_LOSSES[args.model_name]
        schedule = get_lr_schedule(args.lr_scheduler, args.lr, warmup_steps=args.lr_warmup_steps,
                                   train_steps=args.train_steps)

        def make_optimizer(params):
            return get_optimizer(args.optimizer, params, schedule, beta1=args.beta1,
                                 beta2=args.beta2, epsilon=args.epsilon,
                                 weight_decay=args.weight_decay, max_grad_norm=args.max_grad_norm)

        self.lora_mode = args.training_type == "lora"
        self.lora = None
        if self.lora_mode:
            self.lora = install_lora(
                model, rank=args.rank, alpha=float(args.lora_alpha),
                targets=parse_target_modules(args.target_modules),
                generator=torch.Generator(device=self.device).manual_seed(args.seed))
            params = lora_parameters(self.lora)
        else:
            trainable_mask(model)
            params = [p for p in model.parameters() if p.requires_grad]
        self.trainable_names = [n for n, p in model.named_parameters() if p.requires_grad]
        self.optimizer = make_optimizer(params)
        self._grad, self._apply = make_grad_and_apply(loss_fn, self.step_cfg, self.optimizer)

    def merged_params(self) -> Dict[str, torch.Tensor]:
        """The model's weights with what trained in them (``_merged_params``):
        under LoRA the adapters baked into the frozen base."""
        state = {k: v.detach() for k, v in self.model.state_dict().items()}
        if self.lora_mode:
            return merge_lora_into_params(state, self.lora, alpha=float(self.args.lora_alpha),
                                          rank=self.args.rank)
        return state

    def trainable_state_dict(self) -> Dict[str, torch.Tensor]:
        params = dict(self.model.named_parameters())
        return {name: params[name].detach() for name in self.trainable_names}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _resume(self) -> None:
        spec = self.args.resume_from_checkpoint
        restored = self.checkpointer.restore(None if spec == "latest" else int(spec),
                                             map_location=self.device)
        if restored is None:
            logger.info("no checkpoint to resume from in %s", self.checkpointer.dir)
            return
        params = dict(self.model.named_parameters())
        with torch.no_grad():
            for name, value in restored["params"].items():
                params[name].copy_(value)
        self.optimizer.load_state_dict(restored["opt_state"])
        self.train_state = restored["train_state"]
        self.data_position = restored["data_position"]
        logger.info("resumed from step %d", self.train_state.step)

    def _batch(self, stream, sampler: ResolutionSampler) -> Dict[str, torch.Tensor]:
        while not sampler.is_ready:
            sampler.consume(*next(stream))
            self.data_position += 1
        conds, lats = sampler.get_batch()
        batch = {**collate_tensor_dicts(conds), **collate_tensor_dicts(lats)}
        return {k: torch.from_numpy(np.asarray(v)).to(self.device) for k, v in batch.items()
                if not isinstance(v, list)}

    def run(self) -> TrainState:
        args = self.args
        if args.resume_from_checkpoint:
            self._resume()
        reader = PrecomputedReader(args.precomputation_dir)
        stream = reader.stream(self.data_position)
        sampler = ResolutionSampler(args.batch_size)
        while self.train_state.step < args.train_steps:
            batch = self._batch(stream, sampler)
            self.train_state.step += 1
            self.train_state.observed_data_samples += args.batch_size
            step = self.train_state.step
            marks = {}

            def clock(name: str) -> None:
                self._sync()
                marks[name] = time.perf_counter()

            clock("start")
            metrics = self._grad(self.model, batch, step_generator(args.seed, step, self.device),
                                 clock)
            record = {"step": step, "loss": float(metrics["loss"]),
                      "forward_s": marks["forward"] - marks["start"],
                      "backward_s": marks["backward"] - marks["forward"]}
            if step % self.accum_steps == 0:
                record["lr"] = self.optimizer.lr
                record["grad_norm"] = float(self._apply(1.0 / self.accum_steps))
                clock("update")
                record["update_s"] = marks["update"] - marks["backward"]
                record["updates"] = self.optimizer.count
            self.history.append(record)

            if step % args.logging_steps == 0:
                logger.info("step %d: %s", step, {k: v for k, v in record.items() if k != "step"})
            if step % args.checkpointing_steps == 0:
                self.checkpointer.save(step, params=self.trainable_state_dict(),
                                       opt_state=self.optimizer.state_dict(),
                                       train_state=self.train_state,
                                       data_position=self.data_position)
        return self.train_state
