"""Training arguments of the port's SFT paths.

The fields of ``vap_tpu/training/args.py`` ``TrainingArgs`` that these paths
read, with the JAX names, defaults and validation. Two recipes set them:
the CogVideoX VAP expert SFT
(``examples/training/sft/cogvideox/vap_mot/train_single_node.sh``: AdamW,
beta (0.9, 0.99), weight decay 1e-4, lr 1e-5 constant_with_warmup, clip
1.0, gradient checkpointing) and the Wan LoRA finetune
(``examples/training/sft/wan/crush_smol_lora/train.sh``: ``--model_name wan
--training_type lora``, rank 16, alpha 16, ``to_q to_k to_v to_out``, lr
1e-4 with 100 warmup steps, logit-normal flow weighting, the plain structure
of ``config_plain.json``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Union

from .train_step import FLOW_WEIGHTING_SCHEMES

# model_name and training_type values of the JAX trainer that the port does
# not train yet (they raise NotImplementedError; unknown values ValueError)
MODEL_NAMES = ("cogvideox", "wan")
UNPORTED_MODEL_NAMES = ("ltx_video", "hunyuan_video", "cogview4", "flux")
TRAINING_TYPES = ("video_as_prompt_mot", "lora")
UNPORTED_TRAINING_TYPES = ("sft", "dpo", "control", "control_lora", "control_full_finetune")


@dataclasses.dataclass
class TrainingArgs:
    precomputation_dir: Optional[str] = None
    output_dir: str = "output"

    # models
    model_name: str = "cogvideox"                 # cogvideox | wan
    model_structure_config: Optional[str] = None  # JSON with block_idx_with_mot_ref etc.
    training_type: str = "video_as_prompt_mot"    # | lora
    rank: int = 64            # LoRA rank (lora training type)
    lora_alpha: int = 64
    target_modules: str = "default"  # "none" | regex-ish module list (reference style)

    # training
    seed: int = 42
    batch_size: int = 1
    train_steps: int = 60000
    gradient_accumulation_steps: int = 1
    gradient_checkpointing: bool = True
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

    # checkpointing and logging
    checkpointing_steps: int = 500
    checkpointing_limit: Optional[int] = 2
    resume_from_checkpoint: Optional[str] = None  # "latest" or a step number
    logging_steps: int = 10

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
        if self.training_type in UNPORTED_TRAINING_TYPES:
            raise NotImplementedError(f"training_type {self.training_type!r} is not ported to "
                                      f"PyTorch yet")
        if self.training_type not in TRAINING_TYPES:
            raise ValueError(f"unknown training_type {self.training_type}")
        if self.flow_weighting_scheme not in FLOW_WEIGHTING_SCHEMES:
            raise ValueError(f"unknown flow_weighting_scheme {self.flow_weighting_scheme!r}; "
                             f"valid: {FLOW_WEIGHTING_SCHEMES}")

    def model_structure(self) -> Dict[str, Any]:
        """The ``--model_structure_config`` JSON, or {} when none is given."""
        if self.model_structure_config:
            with open(self.model_structure_config) as f:
                return json.load(f)
        return {}

    def remat_mode(self) -> Union[bool, str]:
        """The transformer's ``remat`` argument: "full" under gradient
        checkpointing (the only checkpointing type ported), else False."""
        return "full" if self.gradient_checkpointing else False
