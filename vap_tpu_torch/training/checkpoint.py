"""Training state and checkpoints of the port's trainer.

Port of ``vap_tpu/training/checkpoint.py:25-127`` (``TrainState``,
``Checkpointer``). A checkpoint is one ``torch.save`` file per step,
``step_<step>.pt`` under the checkpoint directory, holding the trainable
parameters' state dict (the MoT expert, or the LoRA adapters'
``lora_A``/``lora_B``), the optimizer's state, the train state and the
position of the data stream; it is written to a temporary name and renamed,
so a crash never leaves a partial file under a step's name. At most
``checkpointing_limit`` files are kept, the oldest removed first.

Not ported yet: the safetensors export of the full weights
(``export_safetensors``), which needs the ``safetensors`` package.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Dict, List, Optional

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


@dataclasses.dataclass
class TrainState:
    """Micro-batches taken (``step``) and samples seen, as in the JAX trainer."""
    step: int = 0
    observed_data_samples: int = 0

    def to_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TrainState":
        return cls(**{k: int(d[k]) for k in ("step", "observed_data_samples") if k in d})


class Checkpointer:
    def __init__(self, directory: str, checkpointing_limit: Optional[int] = None):
        self.dir = os.path.abspath(directory)
        self.limit = checkpointing_limit
        os.makedirs(self.dir, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m[1]) for m in map(_NAME.match, os.listdir(self.dir)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, *, params: Dict[str, torch.Tensor], opt_state: Dict[str, Any],
             train_state: TrainState, data_position: int) -> str:
        path = self.path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save({"params": params, "opt_state": opt_state,
                    "train_state": train_state.to_dict(), "data_position": data_position}, tmp)
        os.replace(tmp, path)
        if self.limit:
            for old in self.all_steps()[:-self.limit]:
                os.remove(self.path(old))
        return path

    def restore(self, step: Optional[int] = None,
                map_location: Any = "cpu") -> Optional[Dict[str, Any]]:
        """The checkpoint of ``step`` (the latest when None), or None when
        there is none: {"step", "params", "opt_state", "train_state",
        "data_position"}."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        if not os.path.exists(self.path(step)):
            raise FileNotFoundError(f"no checkpoint of step {step} in {self.dir}")
        # a file this trainer wrote: tensors, dicts and numbers only
        state = torch.load(self.path(step), map_location=map_location, weights_only=True)
        state["step"] = step
        state["train_state"] = TrainState.from_dict(state["train_state"])
        return state
