"""Training arguments of the port's SFT paths.

The fields of ``vap_tpu/training/args.py`` ``TrainingArgs`` that these paths
read, with the JAX names, defaults and validation. These recipes set them:
the CogVideoX VAP expert SFT
(``examples/training/sft/cogvideox/vap_mot/train_single_node.sh``: AdamW,
beta (0.9, 0.99), weight decay 1e-4, lr 1e-5 constant_with_warmup, clip
1.0, gradient checkpointing) and the Wan LoRA finetune
(``examples/training/sft/wan/crush_smol_lora/train.sh``: ``--model_name wan
--training_type lora``, rank 16, alpha 16, ``to_q to_k to_v to_out``, lr
1e-4 with 100 warmup steps, logit-normal flow weighting, the plain structure
of ``config_plain.json``) and the HunyuanVideo LoRA finetune
(``examples/training/sft/hunyuan_video/modal_labs_dissolve/train.sh``:
``--model_name hunyuan_video --training_type lora``, rank 32, alpha 32,
``to_q to_k to_v to_out``, lr 3e-5 with 1000 warmup steps, AdamW beta
(0.9, 0.99), weight decay 1e-4, logit-normal flow weighting, gradient
checkpointing); the CogVideoX VAP DPO stage
(``examples/training/sft/cogvideox/vap_mot/train_single_node_dpo.sh``:
``--dpo``, rank 32, alpha 32, lr 5e-5 constant), the single-branch
ablations (``vap_mot/ablation/1-single_branch_full.sh``,
``1-single_branch_lora.sh``: ``--ablation_single_branch`` with
``--target_modules none`` or rank 64) and the plain CogVideoX LoRA
(``examples/training/sft/cogvideox/crush_smol_lora/train.sh``:
``--training_type lora`` on ``config_plain.json``). ``training_type``
``sft`` trains what JAX's ``sft`` trains: the MoT partition of a
CogVideoX or Wan model (the whole model for HunyuanVideo), on the plain
dataset.

The parallel flags are JAX's (``vap_tpu/training/args.py:21-25``): one
process per GPU under ``torchrun``; the ``data_degree x fsdp_degree``
ranks take slices of one global batch, ``fsdp_degree`` ranks shard the
parameters, gradients and optimizer state (FSDP2; HSDP with
``data_degree > 1``, ``parallel/sharding.py``: the recipes
``cogvideox/vap_mot/train_single_node_3ref.sh``, 4 x 2, and
``wan/vap_mot/train_single_node.sh``, 2 x 4), and ``seq_degree`` ranks
split each attention's token stream (the ``ring`` provider, with
``cp_rotate_method``), for the three families. The world is
``data_degree x fsdp_degree x seq_degree``; ``tensor_degree`` above 1
raises (tensor parallelism is a later slice), and so does ``fsdp_degree``
above 1 for the control trainer.

JAX's other flags that the released recipes pass are taken as JAX takes
them: ``ref_videos_num`` and ``training_dataset_kind`` (read by nothing, as
in JAX), ``transformer_dtype`` (the same), ``ablation_single_encoder`` and
``ablation_residual_addition`` (set on the CogVideoX structure by
``vap_tpu_torch.train``); the profiling window (``profile_dir``,
``profile_start_step``, ``profile_num_steps``, args.py:134-141, refused
below 1 as JAX refuses them, :158-159).

The data, precompute, validation and tracker fields are JAX's
(``vap_tpu/training/args.py:43-64, 110-132``), with its names and defaults:
``--data_root`` / ``--meta_df_name`` or ``--dataset_config`` (a
``training.json``), the resolution buckets, the reference and caption
masking ratios; ``--enable_precomputation`` (one encode pass into
``--precomputation_dir`` before training, else every sample is encoded
online); ``--validation_dataset_file`` every ``--validation_steps`` under
``--attn_provider_inference``; ``--report_to``.

The rest of training (``vap_tpu/training/args.py:36-40, 79-84, 92-94,
160-224``): the control trainer (``training_type`` ``control`` =
``control_lora``, or ``control_full_finetune``; Wan only here, CogView4's
comes with that family) with ``control_type``, the frame conditioning and
``train_qk_norm``, as the released recipe
``examples/training/control/wan/image_condition/train.sh`` sets them
(Wan2.1-T2V-1.3B, ``control_type none``, ``frame_conditioning_type index``,
index 0 with the mask, rank 64, alpha 64, ``train_qk_norm``, AdamW, lr 3e-5
with 500 warmup steps, logit-normal flow weighting, gradient
checkpointing); ``checkpointing_type`` (``full`` | ``ops`` | ``block_skip``
every ``checkpointing_n_layer`` blocks); float8 storage of the frozen base
under LoRA (``layerwise_upcasting_*``); every optimizer of JAX's
``get_optimizer``.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, Dict, Optional, Tuple, Union

from ..ops.attention import _parse_provider_spec
from .layerwise import DEFAULT_SKIP_PATTERNS, STORAGE_DTYPES
from .train_step import FLOW_WEIGHTING_SCHEMES

# model_name values of the JAX trainer that the port does not train yet
# (they raise NotImplementedError; unknown values ValueError)
MODEL_NAMES = ("cogvideox", "wan", "hunyuan_video")
UNPORTED_MODEL_NAMES = ("ltx_video", "cogview4", "flux")
TRAINING_TYPES = ("video_as_prompt_mot", "sft", "lora", "dpo", "control_lora",
                  "control_full_finetune")
# the control trainer's families (JAX's CONTROL_FAMILY_LOSSES); cogview4's
# comes with that family
CONTROL_MODEL_NAMES = ("wan",)
CONTROL_TYPES = ("canny", "custom", "none")
FRAME_CONDITIONING_TYPES = ("index", "prefix", "random", "first_and_last", "full")
CHECKPOINTING_TYPES = ("full", "ops", "block_skip")
REFERENCE_TRAIN_MODES = (None, "reference_independent")
CP_ROTATE_METHODS = ("allgather", "ppermute", "ulysses")
# model_name values whose trainer takes --seq_degree > 1 in this port
SEQ_PARALLEL_MODEL_NAMES = ("cogvideox", "wan", "hunyuan_video")


@dataclasses.dataclass
class TrainingArgs:
    # parallel (torchrun: one process per GPU; world = data x fsdp x seq)
    data_degree: int = 1
    fsdp_degree: int = 1      # FSDP2 parameter sharding; HSDP with data_degree > 1
    seq_degree: int = 1
    tensor_degree: int = 1    # > 1 not ported (tensor parallelism, a later slice)
    cp_rotate_method: str = "allgather"  # | ppermute | ulysses

    output_dir: str = "output"
    transformer_dtype: str = "bfloat16"  # accepted, read by nothing (as in JAX)

    # dataset
    dataset_config: Optional[str] = None
    data_root: Optional[str] = None
    meta_df_name: str = "vap_data.csv"
    video_resolution_buckets: Tuple[Tuple[int, int, int], ...] = ((49, 480, 720),)
    image_resolution_buckets: Tuple[Tuple[int, int], ...] = ((512, 512),)
    id_token: Optional[str] = None           # LoRA trigger-word prefix
    remove_common_llm_caption_prefixes: bool = False
    enable_precomputation: bool = False
    precomputation_items: int = 8
    precomputation_dir: Optional[str] = None
    precomputation_once: bool = False

    # VAP data flags
    ref_videos_num: int = 5  # accepted, read by nothing (as in JAX)
    sample_ref_videos_num: int = 1
    mask_ref_ratio: float = 0.0
    mask_caption_ratio: float = 0.02
    alignment_score_threshold: float = 5.0
    # one kind's rows only; with ablation_single_branch the trunk over the
    # target alone
    baseline_single_condition: Optional[str] = None
    ablation_scaling_data_num: int = 99999999
    reference_train_mode: Optional[str] = None  # None | "reference_independent"
    random_refer_noise: bool = False  # the reference timesteps reach its time embedding
    num_ref_diffusion_time_sigmas: int = 10
    ref_type: str = "continous_negative"
    training_dataset_kind: str = "vap_data"  # accepted, read by nothing (as in JAX)
    # CogVideoX structure ablations (train.py sets them on the config)
    ablation_single_encoder: bool = False
    ablation_residual_addition: bool = False
    # DPO (as training_type dpo): a LoRA policy over the frozen MoT model
    dpo: bool = False
    # one trunk over [target ‖ references]: the whole model trains under
    # --target_modules none, else LoRA adapters
    ablation_single_branch: bool = False

    # models
    model_name: str = "cogvideox"                 # cogvideox | wan | hunyuan_video
    # a checkpoint directory or cached hub id (its transformer/ component);
    # "" trains random weights from --seed
    pretrained_model_name_or_path: str = ""
    # a finetuned MoT transformer (safetensors file, index or directory)
    videoasprompt_mot_name_or_path: Optional[str] = None
    model_structure_config: Optional[str] = None  # JSON with block_idx_with_mot_ref etc.
    training_type: str = "video_as_prompt_mot"    # | sft | lora | dpo | control*
    # float8 storage of the frozen base under LoRA (training/layerwise.py)
    layerwise_upcasting_modules: str = ""         # "" | "transformer"
    layerwise_upcasting_storage_dtype: str = "float8_e4m3fn"  # | float8_e5m2
    layerwise_upcasting_skip_modules_pattern: str = ",".join(DEFAULT_SKIP_PATTERNS)
    rank: int = 64            # LoRA rank (lora training type)
    lora_alpha: int = 64
    target_modules: str = "default"  # "none" | regex-ish module list (reference style)

    # control training (training/control_trainer.py)
    control_type: str = "canny"            # canny | custom | none
    frame_conditioning_type: str = "full"  # index | prefix | random | first_and_last | full
    frame_conditioning_index: int = 0
    frame_conditioning_concatenate_mask: bool = False
    train_qk_norm: bool = False

    # attention provider of the training step: "auto" (the port's default,
    # "flash"; "ring" under --seq_degree > 1), a bare provider or a per-site
    # spec ("ring cross:flash")
    attn_provider_training: str = "auto"
    # the validation sampling's provider ("auto": the port's default, "flash")
    attn_provider_inference: str = "auto"

    # training
    seed: int = 42
    batch_size: int = 1
    train_steps: int = 60000
    gradient_accumulation_steps: int = 1
    gradient_checkpointing: bool = True
    checkpointing_type: str = "full"  # full | ops | block_skip
    checkpointing_n_layer: int = 2    # block_skip's stride
    flow_weighting_scheme: str = "none"
    flow_logit_mean: float = 0.0
    flow_logit_std: float = 1.0

    # optimizer
    optimizer: str = "adamw"
    lr: float = 1e-5
    lr_scheduler: str = "constant_with_warmup"
    lr_warmup_steps: int = 1000
    beta1: float = 0.9
    beta2: float = 0.99
    weight_decay: float = 1e-4
    epsilon: float = 1e-8
    max_grad_norm: float = 1.0

    # validation, checkpointing and logging
    validation_dataset_file: Optional[str] = None
    validation_steps: int = 500
    checkpointing_steps: int = 500
    checkpointing_limit: Optional[int] = 2
    resume_from_checkpoint: Optional[str] = None  # "latest" or a step number
    logging_steps: int = 10
    report_to: Tuple[str, ...] = ("dummy",)
    tracker_name: str = "vap_tpu"

    # a torch.profiler Chrome trace of the steps [profile_start_step,
    # profile_start_step + profile_num_steps) of this process's run
    profile_dir: Optional[str] = None
    profile_start_step: int = 2
    profile_num_steps: int = 3

    def __post_init__(self):
        if self.gradient_accumulation_steps < 1:
            raise ValueError("gradient_accumulation_steps must be >= 1")
        if self.batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if self.model_name in UNPORTED_MODEL_NAMES:
            raise NotImplementedError(f"model_name {self.model_name!r} is not ported to "
                                      f"PyTorch yet")
        if self.model_name not in MODEL_NAMES:
            raise ValueError(f"unknown model_name {self.model_name}")
        if self.training_type == "control":  # the default control mode
            self.training_type = "control_lora"
        if self.training_type not in TRAINING_TYPES:
            raise ValueError(f"unknown training_type {self.training_type}")
        if self.flow_weighting_scheme not in FLOW_WEIGHTING_SCHEMES:
            raise ValueError(f"unknown flow_weighting_scheme {self.flow_weighting_scheme!r}; "
                             f"valid: {FLOW_WEIGHTING_SCHEMES}")
        if self.cp_rotate_method not in CP_ROTATE_METHODS:
            raise ValueError(f"unknown cp_rotate_method {self.cp_rotate_method!r}; "
                             f"valid: {', '.join(CP_ROTATE_METHODS)}")
        for name in ("data_degree", "fsdp_degree", "seq_degree", "tensor_degree"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1")
        if self.tensor_degree > 1:
            raise NotImplementedError("tensor_degree > 1 is not ported to PyTorch yet: tensor "
                                      "parallelism is a later slice of the port (Wan's QK RMS "
                                      "norm spans every head, so column-parallel q and k need "
                                      "a reduction inside it)")
        if self.fsdp_degree > 1 and self.is_control:
            raise NotImplementedError("fsdp_degree > 1 for the control trainer is not ported: its "
                                      "f32 adapters and the bf16 layers it trains directly share "
                                      "FSDP units, whose gradients reduce in one dtype")
        if self.seq_degree > 1 and self.model_name not in SEQ_PARALLEL_MODEL_NAMES:
            raise NotImplementedError(f"seq_degree > 1 for {self.model_name!r} is not ported "
                                      f"yet: its trainer under --seq_degree is a later slice")
        for spec in (self.attn_provider_training, self.attn_provider_inference):
            if spec not in ("", "auto"):
                _parse_provider_spec(spec)  # raises on an unknown provider
        if self.reference_train_mode not in REFERENCE_TRAIN_MODES:
            raise ValueError(f"unknown reference_train_mode {self.reference_train_mode}")
        if self.ablation_scaling_data_num < 1:
            raise ValueError("ablation_scaling_data_num must be a positive integer")
        if self.validation_steps < 1:
            raise ValueError("validation_steps must be >= 1")
        if self.profile_dir and (self.profile_num_steps < 1 or self.profile_start_step < 1):
            raise ValueError("profile_num_steps and profile_start_step must be >= 1")
        if self.is_control:
            if self.model_name not in CONTROL_MODEL_NAMES:
                raise ValueError(f"control training supports {list(CONTROL_MODEL_NAMES)} "
                                 f"(and cogview4, not ported), got {self.model_name!r}")
            if self.control_type not in CONTROL_TYPES:
                raise ValueError(f"unknown control_type {self.control_type!r}; "
                                 f"valid: {CONTROL_TYPES}")
            if self.frame_conditioning_type not in FRAME_CONDITIONING_TYPES:
                raise ValueError(f"unknown frame_conditioning_type "
                                 f"{self.frame_conditioning_type!r}; valid: "
                                 f"{FRAME_CONDITIONING_TYPES}")
        if self.checkpointing_type not in CHECKPOINTING_TYPES:
            raise ValueError(f"unknown checkpointing_type {self.checkpointing_type!r}; valid: "
                             f"{', '.join(CHECKPOINTING_TYPES)}")
        if self.checkpointing_n_layer < 1:
            raise ValueError("checkpointing_n_layer must be >= 1")
        from .optimizer import OPTIMIZERS

        if self.optimizer not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {self.optimizer!r}; valid: {OPTIMIZERS}")
        for m in self.layerwise_modules:
            if m != "transformer":
                raise ValueError(f"unknown layerwise_upcasting module {m!r}; valid: transformer")
        if self.layerwise_upcasting_storage_dtype not in STORAGE_DTYPES:
            raise ValueError(f"unknown layerwise_upcasting_storage_dtype "
                             f"{self.layerwise_upcasting_storage_dtype!r}; valid: "
                             f"{tuple(STORAGE_DTYPES)}")
        for pat in self.layerwise_skip_patterns:
            try:
                re.compile(pat)
            except re.error as e:
                raise ValueError(f"bad regex in layerwise_upcasting_skip_modules_pattern "
                                 f"{pat!r}: {e}") from None

    @property
    def is_control(self) -> bool:
        return self.training_type.startswith("control")

    @property
    def layerwise_modules(self) -> Tuple[str, ...]:
        return tuple(filter(None, self.layerwise_upcasting_modules.split(",")))

    @property
    def layerwise_skip_patterns(self) -> Tuple[str, ...]:
        return tuple(filter(None, self.layerwise_upcasting_skip_modules_pattern.split(",")))

    @property
    def is_dpo(self) -> bool:
        """``--dpo`` or ``training_type dpo`` (JAX's trainer.py:154)."""
        return bool(self.dpo or self.training_type == "dpo")

    @property
    def world_size(self) -> int:
        """The processes a run takes: data_degree x fsdp_degree x seq_degree."""
        return self.data_degree * self.fsdp_degree * self.seq_degree

    def model_structure(self) -> Dict[str, Any]:
        """The ``--model_structure_config`` JSON, or {} when none is given."""
        if self.model_structure_config:
            with open(self.model_structure_config) as f:
                return json.load(f)
        return {}

    def remat_mode(self) -> Union[bool, str]:
        """The transformer's ``remat`` argument (``remat_mode``, args.py:
        220-226): False without gradient checkpointing, else
        ``checkpointing_type``, "block_skip:<checkpointing_n_layer>" for
        ``block_skip``."""
        if not self.gradient_checkpointing:
            return False
        if self.checkpointing_type == "block_skip":
            return f"block_skip:{self.checkpointing_n_layer}"
        return self.checkpointing_type
