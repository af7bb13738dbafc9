"""Training arguments of the port's CogVideoX VAP SFT path.

The fields of ``vap_tpu/training/args.py`` ``TrainingArgs`` that this path
reads, with the JAX names and defaults (the recipe
``examples/training/sft/cogvideox/vap_mot/train_single_node.sh``: AdamW,
beta (0.9, 0.99), weight decay 1e-4, lr 1e-5 constant_with_warmup, clip 1.0,
gradient checkpointing).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union


@dataclasses.dataclass
class TrainingArgs:
    precomputation_dir: Optional[str] = None
    output_dir: str = "output"

    # training
    seed: int = 42
    batch_size: int = 1
    train_steps: int = 60000
    gradient_accumulation_steps: int = 1
    gradient_checkpointing: bool = True

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

    def remat_mode(self) -> Union[bool, str]:
        """The transformer's ``remat`` argument: "full" under gradient
        checkpointing (the only checkpointing type ported), else False."""
        return "full" if self.gradient_checkpointing else False
