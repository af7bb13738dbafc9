"""The port's SFT trainer for the Video-As-Prompt families (CogVideoX, Wan)
and HunyuanVideo.

Port of ``vap_tpu/training/trainer.py`` ``SFTTrainer`` (``_make_step_config``
:47, ``local_batch_size`` :91, the mesh :136-161, ``_build_step`` :191-235,
``_install_accum`` :252, ``_attn_ctx`` :260-280, ``_prepare_dataset`` :283,
``_offload_encoders`` :341, ``_load_encoders`` :353, ``_precomputed_pairs``
:357, ``_preprocess`` :422, ``run`` :458-602, ``_merged_params`` :605, the
validation :617-793, ``dump_training_sample`` :795), one process per device:
  * ``--training_type video_as_prompt_mot`` (and ``sft``): only the MoT
    expert of CogVideoX or Wan trains (``trainable_mask``), all of
    HunyuanVideo; ``lora``: adapters over the ``--target_modules``
    projections of the frozen model (``install_lora``);
    ``--ablation_single_branch``: the whole model under ``--target_modules
    none``, else adapters over every block; ``--dpo`` (or ``training_type
    dpo``, CogVideoX and Wan): adapters over the MoT expert's six
    projections (``install_dpo_lora``), the frozen model the reference. The
    optimizer holds only what trains (``--optimizer``: AdamW, Adam,
    Adafactor, the 8-bit Adam / AdamW; JAX's layout of each parameter from
    ``jax_layout``); under ``lora`` with ``--layerwise_upcasting_modules
    transformer`` the frozen base is stored in float8 first
    (``cast_layerwise_storage``, trainer.py:218-228); the control trainer
    (``training/control_trainer.py``) subclasses this loop;
  * the loss is the family's: ``cogvideox_vap_loss`` (every mode of the
    step config: plain, ``reference_independent``, the single-branch
    ablations), ``wan_vap_loss`` or ``hunyuan_loss`` (the flow-matching
    flags from the arguments); under DPO ``make_dpo_loss`` over the
    family's per-sample loss;
  * the data: given a spec (``training/specs.py``: the encoders), the
    samples come from ``--data_root`` or ``--dataset_config`` through the
    VAP or the plain video datasets on a prefetching host thread, are
    bucket-fitted and encoded online, one sample at a time
    (``timing/prepare_conditions``, ``timing/prepare_latents``; under DPO
    the lose video too, in the win video's bucket and frame selection:
    ``latents_lose`` and ``dpo_weight``, trainer.py:446-455); under
    ``enable_precomputation`` a pass first encodes them into
    ``precomputation_dir`` (reused when complete under the same signature)
    or, without a directory, ``precomputation_items`` at a time into host
    memory, and the encoders go to host memory while the steps run.
    Without a spec the batches come from a complete precomputed cache
    (JAX's layout), replayed forever. Either way they are bucketed by shape;
  * ``train_state.step`` counts micro-batches; every
    ``gradient_accumulation_steps`` of them the summed gradients are
    averaged and take one optimizer update (trainer.py:548-558);
  * each micro-batch draws its timesteps (sigmas) and noise from a generator
    seeded from (seed, step), so a resumed run draws what an uninterrupted
    one draws (trainer.py:535-538); the LoRA adapters are drawn from
    ``seed``; the datasets' draws come from their own generators;
  * every ``validation_steps``, with ``validation_dataset_file`` set, the
    spec samples its pipeline with the transformer being trained, in
    ``eval()`` under ``no_grad`` and ``attn_provider_inference`` (under
    LoRA the adapted linears merge in their forward: no copy), writing
    ``validation/<step:06d>/sample_<i>.mp4`` (``timing/validation``); the
    training stream is not touched;
  * loss and grad_norm are kept in ``history``, with the seconds of the
    forward, the backward and the update (the device is synchronised at
    each mark), and logged to the tracker (``--report_to``) every
    ``logging_steps`` and at the last step, with the ``timing/*`` spans
    since the last log; on the card, with ``track_stage_peaks``,
    ``stage_peaks`` holds each span's peak device memory (each span then
    resets the card's peak statistics, which the caller asked for);
  * a checkpoint every ``checkpointing_steps`` holds what trains (the
    expert, or the adapters), the optimizer state and the data position
    (the datasets' state, JSON); ``resume_from_checkpoint`` ("latest" or a
    step) restores them, so the sample stream goes on where it stopped;
  * several processes (``torchrun``, ``torch.distributed`` started first):
    a ``DeviceMesh`` of ``data_degree`` x ``fsdp_degree`` x ``seq_degree``
    ranks. Every rank reads the same global batch of ``batch_size x
    data_degree x fsdp_degree`` items and draws that batch's timesteps (or
    sigmas) and noise from the step's generator; each (data, fsdp) rank
    keeps its ``batch_size`` rows (JAX's ``local_batch_size``, :91-98;
    under DPO its pairs, assembled win rows then lose rows on the rank: JAX
    assembles the global batch, ``_assemble_dpo_batch`` :835, which split
    across ranks would part a pair), and the seq ranks of one (data, fsdp)
    group hold the same rows. With ``seq_degree > 1`` the training step
    runs under the attention mesh and the ``ring`` provider (``auto``
    becomes ``ring``, for Wan ``ring cross:flash``: its cross-attentions
    over the 512 text and 257 image keys stay local), whose backward gives
    every seq rank the same gradients; nothing is reduced over ``seq``.
    With ``fsdp_degree > 1`` (or ``shard=True``) the model is sharded
    after LoRA and float8 storage are installed and before the optimizer
    is built (``parallel/sharding.py``: FSDP2, HSDP over ``data``), whose
    reduce-scatter averages the gradients over ``data x fsdp``; otherwise
    each update averages the trainable gradients over the ``data`` group
    once (with accumulation, once per update), before the norm, the clip
    and the update, so every rank applies the same update. The logged loss
    is the mean over the (data, fsdp) ranks. Every rank samples each
    validation, on the same rows with the same seeds (the ``ring``
    provider's collectives and the sharded model's gathers need every
    rank). Only rank 0 writes checkpoints, the precompute cache, the
    validation videos, the exports and logs, in whole tensors gathered from
    the shards (every rank takes part in the gathers); every rank resumes
    from them, a sharded rank cutting its piece;
  * ``--profile_dir``: a ``torch.profiler`` Chrome trace of the steps
    ``profile_start_step`` to ``profile_start_step + profile_num_steps - 1``
    of this process's run (JAX's window, trainer.py:524-600, keyed on the
    process-local step count, so a resumed run traces too; on the card its
    kernels and copies, on the CPU the host's ops with a ``train_step <n>``
    span a step), written as ``<profile_dir>/trace_rank<rank>.json``, the
    profiler kept in ``profile``; a run that ends inside the window stops
    and writes it, one that ends before it warns that no trace was written.

``export`` writes the trained transformer at the end of a run as JAX's
``SFTTrainer.export`` does (``trainer.py:817``): the full weights in
diffusers names (``model_weights/<step>/model.safetensors``) and, under
LoRA, the adapters in PEFT layout beside them
(``pytorch_lora_weights.safetensors``).

Refused as JAX refuses them: DPO with gradient accumulation, with
``enable_precomputation`` or for a family other than CogVideoX and Wan.

Not ported: the image datasets, the validation scorers (CLIP score,
flow metrics) and tensor parallelism.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..data import video as _video
from ..data.dataloader import PrefetchingDataLoader
from ..data.dataset import (VideoAsPromptDataset, VideoAsPromptDPODataset,
                            VideoAsPromptValidationDataset)
from ..data.precomputation import (InMemoryPreprocessor, PrecomputedPreprocessor,
                                   PrecomputedReader)
from ..data.sampler import ResolutionSampler, collate_tensor_dicts
from ..utils.logging import get_logger
from ..utils.trackers import initialize_trackers
from ..ops.attention import attention_provider
from ..parallel import MeshConfig, attention_mesh, make_mesh
from ..parallel.sharding import full_state, local, local_part, rank_of, shard_model
from .args import TrainingArgs
from .checkpoint import Checkpointer, TrainState, export_lora_safetensors, export_safetensors
from .layerwise import cast_layerwise_storage
from .lora import lora_parameters, merge_lora_into_params
from .optimizer import get_lr_schedule, get_optimizer, jax_layout
from .train_step import (DPO_PER_SAMPLE, HunyuanTrainStepConfig, TrainStepConfig,
                         WanTrainStepConfig, cogvideox_vap_loss, draw_step_noise, hunyuan_loss,
                         install_dpo_lora, install_lora, make_dpo_loss, make_grad_and_apply,
                         parse_target_modules, trainable_mask, wan_vap_loss)

logger = get_logger("vap_tpu_torch.trainer")


FAMILY_LOSSES = {"cogvideox": cogvideox_vap_loss, "wan": wan_vap_loss,
                 "hunyuan_video": hunyuan_loss}
# whether the family's full training trains the MoT partition alone
# (JAX's FAMILY_LOSSES, train_step.py:948)
PARTITIONED = {"cogvideox": True, "wan": True, "hunyuan_video": False}
FLOW_STEP_CONFIGS = {"wan": WanTrainStepConfig, "hunyuan_video": HunyuanTrainStepConfig}
# the training step's provider under --seq_degree > 1 when "auto" is asked
# for: Wan's cross-attentions (512 UMT5 and 257 CLIP keys) stay local
SEQ_PROVIDERS = {"wan": "ring cross:flash"}


def _make_step_config(family: str, args: TrainingArgs, transformer_cfg):
    """The family's train-step config (trainer.py:47); the flow-matching
    flags go to the flow families, Wan and HunyuanVideo (CogVideoX trains
    under DDIM with uniform timesteps, as in JAX)."""
    if family in FLOW_STEP_CONFIGS:
        return FLOW_STEP_CONFIGS[family](model=transformer_cfg, remat=args.remat_mode(),
                                         flow_weighting_scheme=args.flow_weighting_scheme,
                                         flow_logit_mean=args.flow_logit_mean,
                                         flow_logit_std=args.flow_logit_std)
    return TrainStepConfig(model=transformer_cfg, reference_train_mode=args.reference_train_mode,
                           random_refer_noise=args.random_refer_noise,
                           num_ref_diffusion_time_sigmas=args.num_ref_diffusion_time_sigmas,
                           sample_ref_videos_num=args.sample_ref_videos_num,
                           ref_type=args.ref_type, remat=args.remat_mode(),
                           ablation_single_branch=args.ablation_single_branch,
                           baseline_single_condition=bool(args.baseline_single_condition))


def assemble_dpo_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Win rows then lose rows (``_assemble_dpo_batch``, trainer.py:835):
    each tensor with a ``<name>_lose`` twin becomes [win ‖ lose] along the
    batch, every other one is repeated (the shared conditioning);
    ``dpo_weight`` stays one per pair, float32."""
    out = {}
    for k, v in batch.items():
        if k.endswith("_lose") or k == "dpo_weight":
            continue
        twin = batch.get(k + "_lose")
        out[k] = torch.cat([v, v if twin is None else twin])
    if "dpo_weight" in batch:
        out["dpo_weight"] = batch["dpo_weight"].float().reshape(-1)
    return out


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The generator of micro-batch ``step``: a function of (seed, step) only."""
    return torch.Generator(device=device).manual_seed((seed << 32) + step)


Pair = Tuple[Dict[str, Any], Dict[str, Any]]


class SFTTrainer:
    def __init__(self, args: TrainingArgs, model: nn.Module, spec=None, *,
                 track_stage_peaks: bool = False, shard: Optional[bool] = None):
        """``shard``: shard the model over the (data, fsdp) ranks (FSDP2);
        by default when ``fsdp_degree > 1``. ``shard=True`` at one process
        shards over a one-rank mesh, which needs ``torch.distributed``
        started on that one process."""
        if spec is None and not args.precomputation_dir:
            raise ValueError("without a spec (the encoders), the trainer trains from a "
                             "precomputed cache: set precomputation_dir")
        if spec is not None:
            if spec.transformer is not model:
                raise ValueError("the spec must hold the transformer being trained")
            if spec.family != args.model_name:
                raise ValueError(f"a {spec.family} spec for model_name {args.model_name}")
            if not (args.data_root or args.dataset_config):
                raise ValueError("training from data needs data_root or dataset_config")
        self._marks: Dict[str, float] = {}  # this step's times by name (``_clock``)
        self.dpo = args.is_dpo
        if self.dpo:  # JAX's refusals (trainer.py:155-158, 205-206, 495-496)
            if args.gradient_accumulation_steps > 1:
                raise ValueError("gradient accumulation is not supported with DPO "
                                 "(reference DPO recipes run with accumulation=1)")
            if args.model_name not in DPO_PER_SAMPLE:
                raise ValueError(f"DPO is only defined for cogvideox/wan, got {args.model_name}")
            if args.enable_precomputation:
                raise ValueError("enable_precomputation is not supported with DPO")
            if spec is None:
                raise ValueError("DPO trains from data (win and lose videos): set data_root")
        self.args = args
        self.model = model
        self.spec = spec
        self.device = next(model.parameters()).device
        self.shard = args.fsdp_degree > 1 if shard is None else bool(shard)
        self.mesh = self._make_mesh()
        self.step_cfg = self._make_step_config()
        self.accum_steps = args.gradient_accumulation_steps
        self._build_step()
        self.train_state = TrainState()
        self.data_position = 0  # items taken from the endless replay of the cache
        self.dataloader_state: Optional[Dict[str, Any]] = None  # the datasets' state
        self.checkpointer = Checkpointer(os.path.join(args.output_dir, "checkpoints"),
                                         args.checkpointing_limit)
        self.tracker = initialize_trackers(args.report_to, args.tracker_name, args.output_dir)
        self.history: List[Dict[str, float]] = []
        self.track_stage_peaks = track_stage_peaks
        self.stage_peaks: Dict[str, int] = {}  # peak device bytes per timing span
        self._host_encoders: Dict[str, nn.Module] = {}
        self._dumped_sample = False
        self.validation_artifacts: Dict[str, str] = {}  # the last validation's videos
        self.last_metrics: Dict[str, torch.Tensor] = {}  # the last micro-batch's loss metrics
        self.profile = None  # the profiler of the --profile_dir window, once it ran

    def _make_step_config(self):
        return _make_step_config(self.args.model_name, self.args, self.model.config)

    def _make_optimizer(self, params):
        """The optimizer of ``--optimizer`` over ``params`` (parameters of
        the model), with JAX's layout of each (``jax_layout``) for the
        optimizers that read it."""
        args = self.args
        schedule = get_lr_schedule(args.lr_scheduler, args.lr, warmup_steps=args.lr_warmup_steps,
                                   train_steps=args.train_steps)
        params = list(params)
        return get_optimizer(args.optimizer, params, schedule, beta1=args.beta1,
                             beta2=args.beta2, epsilon=args.epsilon,
                             weight_decay=args.weight_decay, max_grad_norm=args.max_grad_norm,
                             layout=jax_layout(self.model, params))

    def _make_mesh(self):
        """The (data, fsdp, seq, 1) ``DeviceMesh`` when the run takes more
        than one process or shards (JAX trainer.py:136-143), else None.
        ``batch_rank``: this rank's index among the (data, fsdp) ranks, whose
        rows of the global batch it takes."""
        args = self.args
        self.batch_rank = 0
        self.rank = 0
        if args.world_size == 1 and not self.shard:
            return None
        import torch.distributed as dist

        if not dist.is_initialized() or dist.get_world_size() != args.world_size:
            raise ValueError(
                f"data_degree x fsdp_degree x seq_degree = {args.world_size} needs "
                f"torch.distributed started on that many processes (torchrun --nproc_per_node "
                f"{args.world_size}), got "
                f"{dist.get_world_size() if dist.is_initialized() else 'none'}")
        mesh = make_mesh(MeshConfig(data=args.data_degree, fsdp=args.fsdp_degree,
                                    seq=args.seq_degree), self.device.type)
        self.batch_rank = rank_of(mesh)
        self.rank = dist.get_rank()
        return mesh

    def _attn_ctx(self, training: bool = True):
        """The attention context of the training step, or of validation
        sampling (JAX ``_attn_ctx``, trainer.py:260-280): with a mesh the
        attention mesh is installed (JAX installs it only at ``seq_degree >
        1``; at one seq rank ``ring`` is the local kernel either way), and
        with ``seq_degree > 1`` ``auto`` becomes ``ring`` (``SEQ_PROVIDERS``
        for Wan); any other provider spec is installed as given."""
        name = (self.args.attn_provider_training if training
                else self.args.attn_provider_inference)
        stack = contextlib.ExitStack()
        if self.mesh is not None:
            stack.enter_context(attention_mesh(self.mesh, "seq",
                                               rotate_method=self.args.cp_rotate_method))
            if self.args.seq_degree > 1 and name in ("", "auto"):
                name = SEQ_PROVIDERS.get(self.args.model_name, "ring")
        if name not in ("", "auto"):
            stack.enter_context(attention_provider(name))
        return stack

    def _data_mean(self, tensors) -> None:
        """Average ``tensors`` in place over the (data, fsdp) ranks, which
        hold the rows of one global batch (all-reduces over the ``data`` and
        the ``fsdp`` groups, then the same division on every rank)."""
        groups = [a for a in ("data", "fsdp") if getattr(self.args, f"{a}_degree") > 1]
        if self.mesh is None or not groups:
            return
        import torch.distributed as dist

        n = self.args.data_degree * self.args.fsdp_degree
        for t in tensors:
            for axis in groups:
                dist.all_reduce(t, group=self.mesh.get_group(axis))
            t.div_(n)

    def _build_step(self) -> None:
        """The optimizer and the grad/apply pair of this training type
        (``_build_step``, trainer.py:191-235); what trains is
        ``trainable_names``, the adapters in ``lora`` (LoRA and DPO)."""
        args, model = self.args, self.model
        loss_fn = FAMILY_LOSSES[args.model_name]

        def lora_generator():
            return torch.Generator(device=self.device).manual_seed(args.seed)

        self.lora = None
        self.layerwise_cast: List[str] = []  # the parameters stored in float8
        if self.dpo:  # the adapters are the policy; the frozen model is the reference
            self.lora = install_dpo_lora(model, rank=args.rank, alpha=float(args.lora_alpha),
                                         generator=lora_generator())
            loss_fn = make_dpo_loss(DPO_PER_SAMPLE[args.model_name], clock=self._clock)
        elif args.training_type == "lora" or (args.ablation_single_branch
                                              and args.target_modules != "none"):
            if args.training_type == "lora" and "transformer" in args.layerwise_modules:
                # float8 storage of the frozen base (trainer.py:218-228)
                model.requires_grad_(False)
                self.layerwise_cast = cast_layerwise_storage(
                    model, args.layerwise_upcasting_storage_dtype, args.layerwise_skip_patterns)
            self.lora = install_lora(
                model, rank=args.rank, alpha=float(args.lora_alpha),
                targets=parse_target_modules(args.target_modules), generator=lora_generator())
        elif PARTITIONED[args.model_name] and not args.ablation_single_branch:
            trainable_mask(model)
        else:  # a full finetune: the single-branch ablation, HunyuanVideo
            model.requires_grad_(True)
        if self.shard:  # its parameters become DTensors: the adapters' too
            shard_model(model, self.mesh)
            if self.lora is not None:
                self.lora = {name: {"A": model.get_submodule(name).lora_A,
                                    "B": model.get_submodule(name).lora_B}
                             for name in self.lora}
        self.lora_mode = self.lora is not None
        if self.lora_mode:
            params = lora_parameters(self.lora)
        else:
            params = [p for p in model.parameters() if p.requires_grad]
        self.trainable_names = [n for n, p in model.named_parameters() if p.requires_grad]
        self.optimizer = self._make_optimizer(params)
        # sft trains the MoT partition, which the plain loss never reaches
        self._grad, self._apply = make_grad_and_apply(loss_fn, self.step_cfg, self.optimizer,
                                                      unreached_ok=args.training_type == "sft")

    def merged_params(self, keep: bool = True) -> Optional[Dict[str, torch.Tensor]]:
        """The model's weights with what trained in them (``_merged_params``):
        under LoRA the adapters baked into the frozen base. A sharded model's
        weights are gathered whole, in host memory where ``keep`` (every
        rank must call it); elsewhere None."""
        state = full_state({k: v.detach() for k, v in self.model.state_dict().items()}, keep)
        lora = full_state(self.lora, keep) if self.lora_mode else None
        if not keep:
            return None
        if self.lora_mode:
            return merge_lora_into_params(state, lora, alpha=float(self.args.lora_alpha),
                                          rank=self.args.rank)
        return state

    def export(self, path: Optional[str] = None) -> str:
        """Write the merged weights (``merged_params``) as diffusers-layout
        safetensors, by default ``<output_dir>/model_weights/<step:06d>/
        model.safetensors``; under LoRA also the adapters in PEFT layout,
        ``pytorch_lora_weights.safetensors`` beside it. Rank 0 writes; a
        sharded model is gathered, so every rank calls it. Returns the
        path."""
        path = path or os.path.join(self.args.output_dir, "model_weights",
                                    f"{self.train_state.step:06d}", "model.safetensors")
        keep = self.rank == 0
        if not (keep or self.shard):
            return path
        merged = self.merged_params(keep)
        lora = full_state(self.lora, keep) if self.lora_mode else None
        if keep:
            export_safetensors(merged, path)
            if self.lora_mode:
                export_lora_safetensors(
                    lora, os.path.join(os.path.dirname(path), "pytorch_lora_weights.safetensors"),
                    rank=self.args.rank, alpha=float(self.args.lora_alpha))
        return path

    def trainable_state_dict(self, keep: bool = True) -> Dict[str, Optional[torch.Tensor]]:
        """What trains, by name: whole tensors (a sharded one gathered into
        host memory where ``keep``, else None; every rank must call it)."""
        params = dict(self.model.named_parameters())
        return full_state({name: params[name].detach() for name in self.trainable_names}, keep)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _clock(self, name: str) -> None:
        """Marks this step's time at ``name`` once the card is done."""
        self._sync()
        self._marks[name] = time.perf_counter()

    def _resume(self) -> None:
        spec = self.args.resume_from_checkpoint
        # the file's whole tensors, mapped; each parameter and moment is copied
        # (a sharded rank's pieces of them) onto the device
        restored = self.checkpointer.restore(None if spec == "latest" else int(spec))
        if restored is None:
            logger.info("no checkpoint to resume from in %s", self.checkpointer.dir)
            return
        params = dict(self.model.named_parameters())
        with torch.no_grad():
            for name, value in restored["params"].items():
                local(params[name]).copy_(local_part(value, params[name]))
        self.optimizer.load_state_dict(restored["opt_state"])
        self.train_state = restored["train_state"]
        self.data_position = restored["data_position"]
        if restored.get("dataloader_state"):
            self.dataloader_state = json.loads(restored["dataloader_state"])
        self._dumped_sample = True
        logger.info("resumed from step %d", self.train_state.step)

    @contextlib.contextmanager
    def _stage(self, name: str):
        """A ``timing/*`` span in the tracker; on the card, with
        ``track_stage_peaks``, its peak device memory joins
        ``stage_peaks[name]`` (the card's peak statistics are reset at the
        span's start)."""
        cuda = self.track_stage_peaks and self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        with self.tracker.timed(name):
            yield
        if cuda:
            peak = torch.cuda.max_memory_allocated(self.device)
            self.stage_peaks[name] = max(self.stage_peaks.get(name, 0), peak)

    # ------------------------------------------------------------------
    # the data
    # ------------------------------------------------------------------
    def _prepare_dataset(self) -> PrefetchingDataLoader:
        """The training stream (``_prepare_dataset``, trainer.py:283): the
        ``--dataset_config`` datasets, else the VAP dataset (a VAP training
        type; under DPO the DPO dataset) or the auto-detected video layout
        under ``--data_root``. Every rank reads the same global stream (each
        keeps its rows of a batch)."""
        args = self.args
        if args.dataset_config:
            from ..data.config import build_datasets_from_config

            dataset = build_datasets_from_config(args.dataset_config, args,
                                                 family=args.model_name)
        elif args.training_type == "video_as_prompt_mot" or self.dpo:
            dataset = (VideoAsPromptDPODataset if self.dpo else VideoAsPromptDataset)(
                args.data_root, meta_df_name=args.meta_df_name, infinite=True,
                sample_ref_videos_num=args.sample_ref_videos_num,
                mask_ref_ratio=args.mask_ref_ratio, mask_caption_ratio=args.mask_caption_ratio,
                alignment_score_threshold=args.alignment_score_threshold,
                baseline_single_condition=args.baseline_single_condition,
                ablation_scaling_data_num=args.ablation_scaling_data_num, seed=args.seed)
        else:
            from ..data.generic import DatasetPreprocessingWrapper, initialize_dataset

            dataset = DatasetPreprocessingWrapper(
                initialize_dataset(args.data_root, "video", infinite=True),
                id_token=args.id_token,
                remove_common_llm_caption_prefixes=args.remove_common_llm_caption_prefixes)
        return PrefetchingDataLoader(dataset, prefetch=4)

    def _fit(self, sample: Dict[str, Any]) -> Dict[str, Any]:
        """Bucket-fit the target, reference and (DPO) lose videos; a
        dataset's own buckets and frame selection (``--dataset_config``)
        override the global ones."""
        buckets = sample.get("_resolution_buckets", self.args.video_resolution_buckets)
        fsel = sample.get("_frames_selection", "evenly")
        video, _ = _video.resize_to_nearest_bucket(sample["video"], buckets, fsel)
        refs = [_video.resize_to_nearest_bucket(r, buckets, fsel)[0]
                for r in sample.get("ref_videos", [])]
        sample = dict(sample, video=video, ref_videos=refs)
        if "video_lose" in sample:  # the win video's buckets and frame selection
            sample["video_lose"] = _video.resize_to_nearest_bucket(sample["video_lose"], buckets,
                                                                   fsel)[0]
        return sample

    def _preprocess(self, sample: Dict[str, Any]) -> Pair:
        """decode -> bucket fit -> text and VAE encode; under DPO also the
        lose video's latents (``latents_lose``: the lose video encoded as
        the target, the conditioning shared with the win video) and the
        pair's ``dpo_weight`` [1]."""
        prepare_conditions, prepare_latents = self._timed_encoders()
        sample = self._fit(sample)
        cond, lat = prepare_conditions(sample), prepare_latents(sample)
        if self.dpo:
            lose = prepare_latents(dict(sample, video=sample["video_lose"], ref_videos=[]))
            lat = dict(lat, latents_lose=lose["latents"],
                       dpo_weight=np.asarray([sample.get("dpo_weight", 1.0)], np.float32))
        return cond, lat

    def _offload_encoders(self) -> None:
        """Move the spec's encoders to host memory: the steps run with only
        the transformer on the card."""
        for name, module in self.spec.encoders().items():
            self._host_encoders[name] = module.to("cpu")
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _load_encoders(self) -> None:
        for module in self._host_encoders.values():
            module.to(self.device)
        self._host_encoders = {}

    def _signature(self) -> Dict[str, Any]:
        """What a precomputed cache was made under (JAX's): a cache of
        another signature is recomputed, never replayed."""
        args = self.args
        return {"data_root": str(args.data_root), "dataset_config": str(args.dataset_config or ""),
                "video_resolution_buckets": [list(b) for b in args.video_resolution_buckets or []],
                "precomputation_once": bool(args.precomputation_once),
                "precomputation_items": int(args.precomputation_items)}

    def _precomputed_pairs(self, data_iter: Iterator, epoch_len: int) -> Iterator[Pair]:
        """(condition, latent) pairs forever, the encoders on the card only
        during the encode passes (``_precomputed_pairs``, trainer.py:357)."""
        args = self.args
        if args.precomputation_dir:
            pre = PrecomputedPreprocessor(args.precomputation_dir, signature=self._signature())
            if self.rank == 0 and not pre.is_cached():
                # precomputation_once caches one epoch of the endless stream
                max_items = epoch_len if args.precomputation_once else args.precomputation_items
                n = pre.precompute(map(self._fit, data_iter), *self._timed_encoders(),
                                   max_items=max_items)
                logger.info("precomputed %d items -> %s", n, pre.dir)
            if self.mesh is not None:
                import torch.distributed as dist

                dist.barrier()
            self._offload_encoders()
            yield from PrecomputedReader(args.precomputation_dir).stream(self.data_position)
            return
        pre = InMemoryPreprocessor(map(self._fit, data_iter), *self._timed_encoders(),
                                   num_items=args.precomputation_items)
        while True:
            self._load_encoders()
            buffer = pre.consume()
            self._offload_encoders()
            yield from buffer

    def _timed_encoders(self):
        """The spec's two encode passes, each in its ``timing/*`` span."""
        def timed(name, fn):
            def call(sample):
                with self._stage(name):
                    return fn(sample)
            return call

        return (timed("timing/prepare_conditions", self.spec.prepare_conditions),
                timed("timing/prepare_latents", self.spec.prepare_latents))

    def _online_pairs(self, data_iter: Iterator) -> Iterator[Pair]:
        for raw in data_iter:
            if self.train_state.step == 0 and not self._dumped_sample and self.rank == 0:
                self.dump_training_sample(raw)
                self._dumped_sample = True
            yield self._preprocess(raw)

    def _pairs(self) -> Tuple[Iterator[Pair], Optional[PrefetchingDataLoader]]:
        if self.spec is None:
            return PrecomputedReader(self.args.precomputation_dir).stream(self.data_position), None
        loader = self._prepare_dataset()
        if self.dataloader_state is not None:
            loader.load_state_dict({"dataset": self.dataloader_state})
        data_iter = iter(loader)
        if self.args.enable_precomputation:
            return self._precomputed_pairs(data_iter, len(loader.dataset)), loader
        return self._online_pairs(data_iter), loader

    def _batch(self, stream, sampler: ResolutionSampler) -> Dict[str, torch.Tensor]:
        while not sampler.is_ready:
            sampler.consume(*next(stream))
            self.data_position += 1
        conds, lats = sampler.get_batch()
        batch = {**collate_tensor_dicts(conds), **collate_tensor_dicts(lats)}
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items() if not isinstance(v, list)}

    def _draws(self, batch: Dict[str, torch.Tensor], step: int) -> Dict[str, torch.Tensor]:
        """The random draws of micro-batch ``step`` for the whole global
        batch, from ``step_generator`` (under DPO the pairs', one per win /
        lose pair)."""
        ref = batch.get("latents_mot_ref") if not self.dpo else None
        return draw_step_noise(self.step_cfg, batch["latents"].shape,
                               step_generator(self.args.seed, step, self.device), self.device,
                               ref_shape=None if ref is None else ref.shape)

    def _local(self, x: torch.Tensor) -> torch.Tensor:
        """This (data, fsdp) rank's rows of a global-batch tensor."""
        size = self.args.batch_size
        return x[self.batch_rank * size:(self.batch_rank + 1) * size]

    def run(self) -> TrainState:
        args = self.args
        if args.resume_from_checkpoint:
            self._resume()
        stream, loader = self._pairs()
        global_batch = args.batch_size * args.data_degree * args.fsdp_degree
        sampler = ResolutionSampler(global_batch)
        steps_this_run = 0  # process-local, unlike the resumable step (the profiling window)
        while self.train_state.step < args.train_steps:
            batch = self._batch(stream, sampler)
            if loader is not None:
                self.dataloader_state = loader.state_dict().get("dataset")
            self.train_state.step += 1
            steps_this_run += 1
            if args.profile_dir and steps_this_run == args.profile_start_step:
                self._start_profile()
            self.train_state.observed_data_samples += global_batch
            step = self.train_state.step
            self._marks = marks = {}
            clock = self._clock

            draws = self._draws(batch, step)
            batch = {k: self._local(v) for k, v in batch.items()}
            if self.dpo:
                batch = assemble_dpo_batch(batch)
            with self._stage("timing/train_step"), self._step_span(step):
                clock("start")
                with self._attn_ctx():
                    metrics = self._grad(self.model, batch, None, clock,
                                         **{k: self._local(v) for k, v in draws.items()})
                self.last_metrics = metrics
                logged = ["loss", "model_diff", "ref_diff"] if self.dpo else ["loss"]
                values = [metrics[k].detach().float().clone() for k in logged]
                self._data_mean(values)
                record = {"step": step, **{k: float(v) for k, v in zip(logged, values)}}
                forward_from = "start"
                if self.dpo:
                    record["reference_s"] = marks["reference"] - marks["start"]
                    forward_from = "reference"
                record.update(forward_s=marks["forward"] - marks[forward_from],
                              backward_s=marks["backward"] - marks["forward"])
                if step % self.accum_steps == 0:
                    record["lr"] = self.optimizer.lr
                    # every rank takes part, with zeros where none (sharded: FSDP2 reduced them)
                    if self.mesh is not None and not self.shard:
                        for p in self.optimizer.params:
                            if p.grad is None:
                                p.grad = torch.zeros_like(p)
                        self._data_mean([p.grad for p in self.optimizer.params])
                    record["grad_norm"] = float(self._apply(1.0 / self.accum_steps))
                    clock("update")
                    record["update_s"] = marks["update"] - marks["backward"]
                    record["updates"] = self.optimizer.count
            self.history.append(record)
            if self._profiler is not None and (
                    steps_this_run >= args.profile_start_step + args.profile_num_steps - 1):
                self._stop_profile()

            if args.validation_dataset_file and step % args.validation_steps == 0:
                with self._stage("timing/validation"):
                    self._validate()
            if step % args.checkpointing_steps == 0:
                keep = self.rank == 0  # a sharded state is gathered on every rank, kept on 0
                params = self.trainable_state_dict(keep) if keep or self.shard else None
                opt_state = (full_state(self.optimizer.state_dict(), keep)
                             if keep or self.shard else None)
                if keep:
                    state = None if self.dataloader_state is None else \
                        json.dumps(self.dataloader_state)
                    self.checkpointer.save(step, params=params, opt_state=opt_state,
                                           train_state=self.train_state,
                                           data_position=self.data_position,
                                           dataloader_state=state)
                del params, opt_state
                if self.mesh is not None:  # no rank goes on before the file is whole
                    import torch.distributed as dist

                    dist.barrier()
            if self.rank == 0 and (step % args.logging_steps == 0 or step == args.train_steps):
                logger.info("step %d: %s", step, {k: v for k, v in record.items() if k != "step"})
                self.tracker.log({**{k: v for k, v in record.items() if k != "step"},
                                  "train/observed_data_samples":
                                      self.train_state.observed_data_samples}, step=step)
        if self._profiler is not None:  # train_steps ended inside the window
            self._stop_profile()
        elif args.profile_dir and self.profile is None:
            logger.warning("--profile_dir set but no trace written: the run did only %d "
                           "step(s), fewer than --profile_start_step %d", steps_this_run,
                           args.profile_start_step)
        if loader is not None:
            loader.close()
        self.tracker.finish()
        return self.train_state

    _profiler = None  # the profiler while the window is open

    def _step_span(self, step: int):
        """A ``train_step <step>`` span in the trace while the window is open."""
        if self._profiler is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"train_step {step}")

    def _start_profile(self) -> None:
        """Open the profiling window: a ``torch.profiler`` of the card's
        kernels and copies (on the CPU, of the host's ops: the ``train_step``
        spans). The card's window leaves the host's ops out: a full-width
        step runs tens of thousands, which cost the trace more time than
        the kernels it is for."""
        from torch.profiler import ProfilerActivity, profile

        cuda = self.device.type == "cuda"
        self._profiler = profile(activities=[ProfilerActivity.CUDA if cuda
                                             else ProfilerActivity.CPU])
        self._profiler.__enter__()

    def _stop_profile(self) -> None:
        """Close the window (the card done first) and write its Chrome
        trace."""
        self._sync()
        prof, self._profiler = self._profiler, None
        prof.__exit__(None, None, None)
        os.makedirs(self.args.profile_dir, exist_ok=True)
        path = os.path.join(self.args.profile_dir, f"trace_rank{self.rank}.json")
        prof.export_chrome_trace(path)
        self.profile = prof
        logger.info("profiler trace written to %s", path)

    # ------------------------------------------------------------------
    # validation
    # ------------------------------------------------------------------
    def _load_validation_config(self):
        """``--validation_dataset_file``: a JSON pointing at a benchmark CSV
        with the generation's parameters (the recipes' ``validation.json``),
        or a bare CSV. Returns (csv_path, gen_kwargs, num_samples)."""
        args = self.args
        path = args.validation_dataset_file
        gen: Dict[str, Any] = {}
        if not path.endswith(".json"):
            return path, gen, None
        with open(path) as f:
            vcfg = json.load(f)
        csv = vcfg.get("csv") or vcfg.get("val_data")
        if isinstance(csv, list):
            csv = csv[0]
        for base in (os.path.dirname(os.path.abspath(path)), args.data_root or "",
                     vcfg.get("root", "")):
            cand = os.path.join(base, csv) if base else csv
            if os.path.exists(cand):
                csv = cand
                break
        for k in ("num_frames", "height", "width", "num_inference_steps", "guidance_scale",
                  "use_dynamic_cfg", "step_cache"):
            if k in vcfg:
                gen[k] = vcfg[k]
        return csv, gen, vcfg.get("num_samples")

    def _resolve_val_limit(self, num_samples, total: int) -> Optional[int]:
        """The validation sample cap: ``"all"`` or -1, every row (None); an
        unset cap one sample, with a warning when there are more; else n."""
        if num_samples == "all" or num_samples == -1:
            return None
        if num_samples is None:
            if total > 1:
                logger.warning("validation: no num_samples configured — generating 1 of %d rows. "
                               "Set num_samples in the validation JSON (an integer, or \"all\" "
                               "for every row) to change this.", total)
            return 1
        return int(num_samples)

    def _validate(self) -> None:
        """Sample the spec's pipeline with the transformer being trained
        (``_validate``, trainer.py:667): the benchmark CSV's rows (VAP) or
        the JSON's ``data`` prompts (a plain finetune). The module goes into
        ``eval()`` and back; a fresh generator per sample, so the training
        stream and its draws are untouched. Every rank samples (the seq
        group's collectives need each of its ranks); rank 0 writes."""
        if self.spec is None:
            raise ValueError("validation needs a spec (the encoders and the VAE)")
        model = self.model
        if self.train_state.step % self.accum_steps == 0:
            for p in model.parameters():  # nothing is mid-accumulation: free the gradients
                p.grad = None
        was_training = model.training
        reload = bool(self._host_encoders)
        if reload:
            self._load_encoders()
        model.eval()
        try:
            with torch.no_grad():
                samples, gen_kwargs, num_samples = self._validation_samples()
                out_dir = os.path.join(self.args.output_dir, "validation",
                                       f"{self.train_state.step:06d}")
                if self.rank == 0:
                    os.makedirs(out_dir, exist_ok=True)
                artifacts = {}
                for i, (sample, kwargs) in enumerate(samples):
                    if num_samples is not None and i >= num_samples:
                        break
                    with self._attn_ctx(training=False):
                        video = self.spec.validation(sample, seed=self.args.seed + i,
                                                     **{**gen_kwargs, **kwargs})
                    if self.rank == 0:
                        self._write_validation_sample(np.asarray(video), out_dir, i, artifacts)
                if self.rank == 0:
                    self.tracker.log_artifacts(artifacts, step=self.train_state.step)
                    self.validation_artifacts = artifacts
        finally:
            model.train(was_training)
            if reload:
                self._offload_encoders()

    def _validation_samples(self):
        """(an iterator of (sample, per-sample kwargs), shared kwargs, the
        sample cap): the validation JSON's ``num_samples``."""
        args = self.args
        fb = args.video_resolution_buckets[0]
        path = args.validation_dataset_file
        if path.endswith(".json"):
            with open(path) as f:
                vcfg = json.load(f)
            if isinstance(vcfg, list) or ("data" in vcfg and not (vcfg.get("csv")
                                                                   or vcfg.get("val_data"))):
                # prompt-driven validation of a plain finetune (_validate_generic)
                data = vcfg.get("data", []) if isinstance(vcfg, dict) else vcfg
                num_samples = self._resolve_val_limit(
                    vcfg.get("num_samples") if isinstance(vcfg, dict) else None, len(data))

                def generic():
                    for sample in data:
                        kw = dict(height=sample.get("height", fb[1]),
                                  width=sample.get("width", fb[2]),
                                  num_frames=sample.get("num_frames", fb[0]),
                                  num_inference_steps=sample.get("num_inference_steps", 30))
                        if "guidance_scale" in sample:
                            kw["guidance_scale"] = sample["guidance_scale"]
                        yield sample, kw
                return generic(), {}, num_samples
        csv_path, gen, num_samples = self._load_validation_config()
        ds = VideoAsPromptValidationDataset(csv_path, num_frames=gen.get("num_frames", fb[0]))
        num_samples = self._resolve_val_limit(num_samples, len(ds))
        gen_kwargs = dict(height=gen.get("height", fb[1]), width=gen.get("width", fb[2]),
                          num_frames=gen.get("num_frames", fb[0]),
                          num_inference_steps=gen.get("num_inference_steps", 50))
        for k in ("guidance_scale", "use_dynamic_cfg", "step_cache"):
            if k in gen:
                gen_kwargs[k] = gen[k]
        return ((sample, {}) for sample in ds), gen_kwargs, num_samples

    def _write_validation_sample(self, media: np.ndarray, out_dir: str, i: int,
                                 artifacts: Dict[str, str]) -> None:
        """Write one [-1, 1] [F, H, W, 3] sample as ``sample_<i>.mp4``."""
        path = os.path.join(out_dir, f"sample_{i}.mp4")
        _video.export_to_video((media + 1.0) / 2.0, path, fps=16)
        artifacts[f"validation/sample_{i}"] = path
        logger.info("validation sample written: %s", path)

    def dump_training_sample(self, sample: Dict[str, Any], step: int = 0) -> None:
        """The decoded target and reference videos and the captions of the
        first training sample, under ``training_samples/``, for a look."""
        out_dir = os.path.join(self.args.output_dir, "training_samples")
        os.makedirs(out_dir, exist_ok=True)
        _video.export_to_video((sample["video"] + 1.0) / 2.0,
                               os.path.join(out_dir, f"{step}-training_sample.mp4"), fps=16)
        for ri, rv in enumerate(sample.get("ref_videos", [])):
            _video.export_to_video((rv + 1.0) / 2.0, os.path.join(out_dir, f"{step}-ref_{ri}.mp4"),
                                   fps=16)
        with open(os.path.join(out_dir, f"{step}-caption.txt"), "w") as f:
            f.write(str(sample.get("caption", "")) + "\n")
            for c in sample.get("caption_mot_ref", []):
                f.write(str(c) + "\n")
