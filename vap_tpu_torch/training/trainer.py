"""The port's SFT trainer for the Video-As-Prompt families (CogVideoX, Wan)
and HunyuanVideo.

Port of ``vap_tpu/training/trainer.py`` ``SFTTrainer`` (``_make_step_config``
:47, ``local_batch_size`` :91, the mesh :136-161, ``_build_step`` :191-235,
``_install_accum`` :252, ``_attn_ctx`` :260-280, ``run`` :458-602,
``_merged_params`` :605), one process per device:
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
    position;
  * several processes (``torchrun``, ``torch.distributed`` started first):
    a ``DeviceMesh`` of ``data_degree`` x ``seq_degree`` ranks. Every rank
    reads the same global batch of ``batch_size x data_degree`` items and
    draws that batch's timesteps (or sigmas) and noise from the step's
    generator; each data rank keeps its ``batch_size`` rows, and the seq
    ranks of one data group hold the same rows. With ``seq_degree > 1`` the
    training step runs under the attention mesh and the ``ring`` provider
    (``auto`` becomes ``ring``), whose backward gives every seq rank the
    same gradients. Each update averages the trainable gradients over the
    ``data`` group once (with accumulation, once per update), before the
    norm, the clip and AdamW, so every rank applies the same update; the
    logged loss is the data group's mean. Only rank 0 (data rank 0, seq
    rank 0) writes checkpoints and logs; every rank resumes from them.

``export`` writes the trained transformer at the end of a run as JAX's
``SFTTrainer.export`` does (``trainer.py:817``): the full weights in
diffusers names (``model_weights/<step>/model.safetensors``) and, under
LoRA, the adapters in PEFT layout beside them
(``pytorch_lora_weights.safetensors``).

Not ported: validation sampling, DPO, parameter sharding (FSDP, tensor
parallelism), the profiler window and the trackers.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..data.precomputation import PrecomputedReader
from ..data.sampler import ResolutionSampler, collate_tensor_dicts
from ..ops.attention import attention_provider
from ..parallel import MeshConfig, attention_mesh, make_mesh
from .args import TrainingArgs
from .checkpoint import Checkpointer, TrainState, export_lora_safetensors, export_safetensors
from .lora import lora_parameters, merge_lora_into_params
from .optimizer import get_lr_schedule, get_optimizer
from .train_step import (HunyuanTrainStepConfig, TrainStepConfig, WanTrainStepConfig,
                         cogvideox_vap_loss, draw_step_noise, hunyuan_loss, install_lora,
                         make_grad_and_apply, parse_target_modules, trainable_mask, wan_vap_loss)

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
        self.mesh = self._make_mesh()
        self.step_cfg = _make_step_config(args.model_name, args, model.config)
        self.accum_steps = args.gradient_accumulation_steps
        self._build_step()
        self.train_state = TrainState()
        self.data_position = 0  # items taken from the endless replay of the cache
        self.checkpointer = Checkpointer(os.path.join(args.output_dir, "checkpoints"),
                                         args.checkpointing_limit)
        self.history: List[Dict[str, float]] = []

    def _make_mesh(self):
        """The (data, 1, seq, 1) ``DeviceMesh`` when the run takes more than
        one process (JAX trainer.py:136-143), else None."""
        args = self.args
        self.data_rank = 0
        self.rank = 0
        if args.world_size == 1:
            return None
        import torch.distributed as dist

        if not dist.is_initialized() or dist.get_world_size() != args.world_size:
            raise ValueError(
                f"data_degree x seq_degree = {args.world_size} needs torch.distributed started "
                f"on that many processes (torchrun --nproc_per_node {args.world_size}), got "
                f"{dist.get_world_size() if dist.is_initialized() else 'none'}")
        mesh = make_mesh(MeshConfig(data=args.data_degree, seq=args.seq_degree),
                         self.device.type)
        self.data_rank = mesh.get_local_rank("data")
        self.rank = dist.get_rank()
        return mesh

    def _attn_ctx(self):
        """The training step's attention context (JAX ``_attn_ctx``,
        trainer.py:260-280): with a mesh the attention mesh is installed
        (JAX installs it only at ``seq_degree > 1``; at one seq rank
        ``ring`` is the local kernel either way), and with ``seq_degree > 1``
        ``auto`` becomes ``ring``; any other provider spec is installed as
        given."""
        name = self.args.attn_provider_training
        stack = contextlib.ExitStack()
        if self.mesh is not None:
            stack.enter_context(attention_mesh(self.mesh, "seq",
                                               rotate_method=self.args.cp_rotate_method))
            if self.args.seq_degree > 1 and name in ("", "auto"):
                name = "ring"
        if name not in ("", "auto"):
            stack.enter_context(attention_provider(name))
        return stack

    def _data_mean(self, tensors) -> None:
        """Average ``tensors`` in place over the ``data`` group (all-reduce,
        then the same division on every rank)."""
        if self.mesh is None or self.args.data_degree == 1:
            return
        import torch.distributed as dist

        group = self.mesh.get_group("data")
        for t in tensors:
            dist.all_reduce(t, group=group)
            t.div_(self.args.data_degree)

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

    def export(self, path: Optional[str] = None) -> str:
        """Write the merged weights (``merged_params``) as diffusers-layout
        safetensors, by default ``<output_dir>/model_weights/<step:06d>/
        model.safetensors``; under LoRA also the adapters in PEFT layout,
        ``pytorch_lora_weights.safetensors`` beside it. Returns the path."""
        path = path or os.path.join(self.args.output_dir, "model_weights",
                                    f"{self.train_state.step:06d}", "model.safetensors")
        export_safetensors(self.merged_params(), path)
        if self.lora_mode:
            export_lora_safetensors(
                self.lora, os.path.join(os.path.dirname(path), "pytorch_lora_weights.safetensors"),
                rank=self.args.rank, alpha=float(self.args.lora_alpha))
        return path

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

    def _local(self, x: torch.Tensor) -> torch.Tensor:
        """This data rank's rows of a global-batch tensor."""
        size = self.args.batch_size
        return x[self.data_rank * size:(self.data_rank + 1) * size]

    def run(self) -> TrainState:
        args = self.args
        if args.resume_from_checkpoint:
            self._resume()
        reader = PrecomputedReader(args.precomputation_dir)
        stream = reader.stream(self.data_position)
        global_batch = args.batch_size * args.data_degree
        sampler = ResolutionSampler(global_batch)
        while self.train_state.step < args.train_steps:
            batch = self._batch(stream, sampler)
            self.train_state.step += 1
            self.train_state.observed_data_samples += global_batch
            step = self.train_state.step
            marks = {}

            def clock(name: str) -> None:
                self._sync()
                marks[name] = time.perf_counter()

            draws = draw_step_noise(self.step_cfg, batch["latents"].shape,
                                    step_generator(args.seed, step, self.device), self.device)
            batch = {k: self._local(v) for k, v in batch.items()}
            clock("start")
            with self._attn_ctx():
                metrics = self._grad(self.model, batch, None, clock,
                                     **{k: self._local(v) for k, v in draws.items()})
            loss = metrics["loss"].detach().clone()
            self._data_mean([loss])
            record = {"step": step, "loss": float(loss),
                      "forward_s": marks["forward"] - marks["start"],
                      "backward_s": marks["backward"] - marks["forward"]}
            if step % self.accum_steps == 0:
                record["lr"] = self.optimizer.lr
                if self.mesh is not None:  # every rank takes part, with zeros where none
                    for p in self.optimizer.params:
                        if p.grad is None:
                            p.grad = torch.zeros_like(p)
                    self._data_mean([p.grad for p in self.optimizer.params])
                record["grad_norm"] = float(self._apply(1.0 / self.accum_steps))
                clock("update")
                record["update_s"] = marks["update"] - marks["backward"]
                record["updates"] = self.optimizer.count
            self.history.append(record)

            if self.rank == 0 and step % args.logging_steps == 0:
                logger.info("step %d: %s", step, {k: v for k, v in record.items() if k != "step"})
            if step % args.checkpointing_steps == 0:
                if self.rank == 0:
                    self.checkpointer.save(step, params=self.trainable_state_dict(),
                                           opt_state=self.optimizer.state_dict(),
                                           train_state=self.train_state,
                                           data_position=self.data_position)
                if self.mesh is not None:  # no rank goes on before the file is whole
                    import torch.distributed as dist

                    dist.barrier()
        return self.train_state
