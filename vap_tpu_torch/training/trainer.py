"""The port's SFT trainer for the CogVideoX Video-As-Prompt family.

Port of ``vap_tpu/training/trainer.py`` ``SFTTrainer`` (``_build_step``
:191, ``_install_accum`` :252, ``run`` :458-602) on one device:
  * only the MoT expert trains (``trainable_mask``); the optimizer holds only
    its parameters;
  * the batches come from the precomputed ``.npz`` cache, replayed forever
    and bucketed by shape; the text encoder and the VAE never load;
  * ``train_state.step`` counts micro-batches; every
    ``gradient_accumulation_steps`` of them the summed gradients are
    averaged and take one optimizer update (trainer.py:548-558);
  * each micro-batch draws its timesteps and noise from a generator seeded
    from (seed, step), so a resumed run draws what an uninterrupted one
    draws (trainer.py:535-538);
  * loss and grad_norm are logged every ``logging_steps`` and kept in
    ``history``, with the seconds of the forward, the backward and the
    update (the device is synchronised at each mark);
  * a checkpoint every ``checkpointing_steps``; ``resume_from_checkpoint``
    ("latest" or a step) restores parameters, optimizer, train state and the
    data position.

Not ported: validation sampling, DPO and LoRA, the device mesh, the
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
from .optimizer import get_lr_schedule, get_optimizer
from .train_step import TrainStepConfig, cogvideox_vap_loss, make_grad_and_apply, trainable_mask

logger = logging.getLogger("vap_tpu_torch.trainer")


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
        self.step_cfg = TrainStepConfig(model=model.config, remat=args.remat_mode())
        self.trainable_names = trainable_mask(model)
        schedule = get_lr_schedule(args.lr_scheduler, args.lr, warmup_steps=args.lr_warmup_steps,
                                   train_steps=args.train_steps)
        self.optimizer = get_optimizer(
            args.optimizer, (p for p in model.parameters() if p.requires_grad), schedule,
            beta1=args.beta1, beta2=args.beta2, epsilon=args.epsilon,
            weight_decay=args.weight_decay, max_grad_norm=args.max_grad_norm)
        self.accum_steps = args.gradient_accumulation_steps
        self._grad, self._apply = make_grad_and_apply(cogvideox_vap_loss, self.step_cfg,
                                                      self.optimizer)
        self.train_state = TrainState()
        self.data_position = 0  # items taken from the endless replay of the cache
        self.checkpointer = Checkpointer(os.path.join(args.output_dir, "checkpoints"),
                                         args.checkpointing_limit)
        self.history: List[Dict[str, float]] = []

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
