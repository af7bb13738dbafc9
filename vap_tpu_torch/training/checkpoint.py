"""Training state, checkpoints and exportable weights of the port's trainer.

Port of ``vap_tpu/training/checkpoint.py``. Training state
(``TrainState``, ``Checkpointer``, :25-127): a checkpoint is one ``torch.save`` file per step,
``step_<step>.pt`` under the checkpoint directory, holding the trainable
parameters' state dict (the MoT expert, or the LoRA adapters'
``lora_A``/``lora_B``, and what control LoRA trains directly), the
optimizer's state (AdamW's moments, Adafactor's factored ones, the 8-bit
Adam's int8 codes and float32 scales, each with its update count), the
train state and the position of the data stream; it is written to a temporary name and renamed,
so a crash never leaves a partial file under a step's name. At most
``checkpointing_limit`` files are kept, the oldest removed first.

Exportable weights (:132-380), in safetensors through the port's own
reader and writer (``utils/safetensors.py``): ``load_safetensors`` (a file,
a sharded index or a component directory), ``export_safetensors`` (the
full transformer in diffusers names), ``export_lora_safetensors`` (PEFT
names ``transformer.<module>.lora_{A,B}.weight``, [out, in] orientation,
the ``lora_config`` in the header), ``merge_lora_into_state_dict`` and
``load_lora_metadata``, and the control trainer's directly trained tensors
(``export_control_layers``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from collections.abc import Mapping
from typing import Any, Dict, List, Optional

import torch

from ..utils.safetensors import SafetensorsDict, read_metadata, save_file

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
             train_state: TrainState, data_position: int,
             dataloader_state: Optional[str] = None) -> str:
        """``dataloader_state``: the datasets' state as JSON (None without
        datasets)."""
        path = self.path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save({"params": params, "opt_state": opt_state,
                    "train_state": train_state.to_dict(), "data_position": data_position,
                    "dataloader_state": dataloader_state}, tmp)
        os.replace(tmp, path)
        if self.limit:
            for old in self.all_steps()[:-self.limit]:
                os.remove(self.path(old))
        return path

    def restore(self, step: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """The checkpoint of ``step`` (the latest when None), or None when
        there is none: {"step", "params", "opt_state", "train_state",
        "data_position", "dataloader_state"}. Its tensors are copy-on-write
        views of the file in host memory, read as they are used (the ranks
        of a sharded run each read their pieces of one page-cached file)."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        if not os.path.exists(self.path(step)):
            raise FileNotFoundError(f"no checkpoint of step {step} in {self.dir}")
        # a file this trainer wrote: tensors, dicts and numbers only
        state = torch.load(self.path(step), map_location="cpu", weights_only=True, mmap=True)
        state["step"] = step
        state["train_state"] = TrainState.from_dict(state["train_state"])
        return state


# ---------------------------------------------------------------------------
# safetensors in the diffusers / PEFT layout
# ---------------------------------------------------------------------------

# transformers components ship model.safetensors; diffusers components
# (transformer, vae) diffusion_pytorch_model.safetensors
# (vap_tpu/training/checkpoint.py:236-241)
COMPONENT_FILES = ("model.safetensors", "model.safetensors.index.json",
                   "diffusion_pytorch_model.safetensors",
                   "diffusion_pytorch_model.safetensors.index.json")


def load_safetensors(path: str) -> SafetensorsDict:
    """The tensors of a file, of a sharded index (``*.index.json``: the
    files of its ``weight_map``), or of a component directory (the first of
    ``COMPONENT_FILES`` present), as one mapping of views of the mapped
    files."""
    if os.path.isdir(path):
        for name in COMPONENT_FILES:
            if os.path.exists(os.path.join(path, name)):
                path = os.path.join(path, name)
                break
        else:
            raise FileNotFoundError(f"no (sharded) safetensors under {path}")
    if path.endswith(".index.json"):
        with open(path) as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
        return SafetensorsDict([os.path.join(os.path.dirname(path), s) for s in shards])
    return SafetensorsDict([path])


def export_safetensors(state: Mapping, path: str,
                       metadata: Optional[Dict[str, str]] = None) -> int:
    """Write a transformer's full weights ({diffusers key: tensor}: the
    trainer's ``merged_params``) to ``path``, ``{"format": "pt"}`` in the
    header unless ``metadata`` is given. The port's state dicts carry
    exactly the names JAX's flatteners write (``_flatten_to_reference_names``,
    ``flatten_wan_state_dict``, ``flatten_wan_mot_state_dict``,
    ``flatten_hunyuan_video_state_dict``). W8A8 weights raise: JAX exports
    only floating parameters. Returns the bytes written."""
    quantised = [k for k in state if k.endswith((".w_i8", ".s_w"))]
    if quantised:
        raise ValueError(f"the model is quantised to W8A8 ({quantised[0]}, ...); export the "
                         f"bf16 / f32 weights before quantize_transformer_linears")
    adapters = [k for k in state if k.endswith((".lora_A", ".lora_B"))]
    if adapters:
        raise ValueError(f"{adapters[0]}: merge the LoRA adapters first (merge_lora_into_params)")
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    return save_file(dict(state), path, metadata)


# the module-list prefixes whose adapters JAX's export_lora_safetensors
# walks (its stacked blocks; :296-314); Wan's blocks keep their diffusers
# name ``blocks``, where JAX writes ``transformer_blocks``
LORA_BLOCK_PREFIXES = ("transformer_blocks.", "single_transformer_blocks.", "blocks.")
# projection names longer than one component (vap_tpu/training/checkpoint.py:261)
_LORA_SHORT = ("to_out.0", "net.0.proj", "net.2")


def lora_short_name(module: str) -> str:
    """The ``target_modules`` entry of an adapted module: ``to_q``,
    ``to_out.0``, ``net.0.proj`` ..."""
    return next((s for s in _LORA_SHORT if module.endswith("." + s)), module.rsplit(".", 1)[-1])


def export_lora_safetensors(lora: Mapping, path: str, *, rank: int, alpha: float,
                            metadata: Optional[Dict[str, str]] = None) -> int:
    """Write the adapters ({module name: {"A" [in, r], "B" [r, out]}}) of
    the transformer's blocks as PEFT-layout safetensors with the lora config
    in the header (``export_lora_safetensors``): ``transformer.<module>.
    lora_A.weight`` = A^T [r, in] and ``lora_B.weight`` = B^T [out, r].
    As in JAX, adapters outside the block stacks (HunyuanVideo's token
    refiner) are not written. Returns the bytes written."""
    out: Dict[str, torch.Tensor] = {}
    targets = set()
    for name, ab in lora.items():
        if not name.startswith(LORA_BLOCK_PREFIXES):
            continue
        targets.add(lora_short_name(name))
        out[f"transformer.{name}.lora_A.weight"] = ab["A"].detach().t().contiguous()
        out[f"transformer.{name}.lora_B.weight"] = ab["B"].detach().t().contiguous()
    config = {"r": int(rank), "lora_alpha": float(alpha), "peft_type": "LORA",
              "target_modules": sorted(targets)}
    meta = {"format": "pt", "lora_config": json.dumps(config)}
    meta.update(metadata or {})
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    return save_file(out, path, meta)


def export_control_layers(tensors: Mapping, path: str) -> int:
    """Write what control LoRA trains directly ({module parameter name:
    tensor}: the widened injection layer's weight, the QK norms' weights)
    as ``transformer.<name>`` in diffusers names and layout
    (``control_injection_layers.safetensors``; JAX's file names its stacked
    tree's leaves). Returns the bytes written."""
    out = {f"transformer.{name}": t.detach().contiguous() for name, t in tensors.items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    return save_file(out, path, {"format": "pt"})


def load_lora_metadata(path: str) -> Dict[str, Any]:
    """The ``lora_config`` embedded in a safetensors header, or {}."""
    meta = read_metadata(path)
    return json.loads(meta["lora_config"]) if "lora_config" in meta else {}


def merge_lora_into_state_dict(sd: Mapping, lora_path: str,
                               scale: Optional[float] = None) -> Dict[str, torch.Tensor]:
    """Fuse PEFT-layout adapters (``transformer.<module>.lora_{A,B}.weight``)
    into a diffusers-layout state dict before loading it, as
    ``merge_lora_into_state_dict`` does: W <- (W in f32 + scale * B @ A)
    cast to W's dtype, ``scale`` lora_alpha / r from the header (1.0
    without one). The product runs in numpy in f32, as JAX's does, so the
    merge agrees with JAX's to the bit; the add and the cast run where W
    lies. Raises ``KeyError`` for an adapter without its base weight and
    ``ValueError`` for a file without adapters."""
    lora = load_safetensors(lora_path)
    if scale is None:
        meta = load_lora_metadata(lora_path)
        scale = (float(meta["lora_alpha"]) / float(meta["r"])
                 if "lora_alpha" in meta and "r" in meta else 1.0)
    out = dict(sd)
    merged = 0
    for key in lora:
        if not key.endswith(".lora_A.weight"):
            continue
        base = key[: -len(".lora_A.weight")]
        a, b = lora[key], lora[base + ".lora_B.weight"]
        name = base[len("transformer."):] if base.startswith("transformer.") else base
        wkey = name + ".weight"
        if wkey not in out:
            raise KeyError(f"LoRA targets missing base weight {wkey!r} (from {lora_path})")
        w = out[wkey]
        delta = b.float().numpy() @ a.float().numpy()
        delta *= scale  # in place: the same f32 product as scale * (b @ a), one array fewer
        out[wkey] = (w.float() + torch.from_numpy(delta).to(w.device)).to(w.dtype)
        merged += 1
    if merged == 0:
        raise ValueError(f"no '*.lora_A.weight' adapters found in {lora_path}")
    return out
