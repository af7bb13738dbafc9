"""Layerwise upcasting: float8 storage of the frozen base in LoRA training.

Port of ``vap_tpu/training/layerwise.py``. ``--layerwise_upcasting_modules
transformer`` under ``--training_type lora`` (``vap_tpu/training/trainer.py:
218-228``) stores the frozen transformer's floating parameters in
``float8_e4m3fn`` or ``float8_e5m2``, except those under a module whose
dotted name matches a skip pattern, and upcasts them to the compute dtype
where they are used (``training/lora.py``): the resident weights of every
cast linear take half their bf16 bytes, and only the linear running holds
its upcast copy.

Matching is JAX's: every dotted module name on a parameter's path
("blocks", "blocks.0", "blocks.0.attn1", ...) is ``re.search``-ed against
the patterns, so "ff.net" reaches into a subtree and "^proj_out$" hits only
a top-level module; a top-level parameter is matched by its own name. The
port's names are the diffusers ones, so the cast set is JAX's set read
through the weight converter (``convert.py``; tests/test_torch_layerwise.py
holds it so for the default patterns).
"""

from __future__ import annotations

import re
from typing import List, Sequence

import torch
from torch import nn

# the JAX package's defaults (vap_tpu/training/layerwise.py, after the
# reference's finetrainers/args.py:409)
DEFAULT_SKIP_PATTERNS = (
    "patch_embed", "pos_embed", "x_embedder", "context_embedder",
    "time_embed", r"^proj_in$", r"^proj_out$", "norm",
)

STORAGE_DTYPES = {
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
}
FLOAT8_DTYPES = tuple(STORAGE_DTYPES.values())


def compute_dtype(model: nn.Module) -> torch.dtype:
    """The compute dtype of a model that may hold float8 storage: the
    dtype of its first floating parameter that is not float8 (JAX's
    ``_non_storage_dtype``; ``cast_layerwise_storage`` always leaves one),
    bf16 when there is none."""
    for p in model.parameters():
        if p.is_floating_point() and p.dtype not in FLOAT8_DTYPES:
            return p.dtype
    return torch.bfloat16


def skipped(name: str, patterns: Sequence[re.Pattern]) -> bool:
    """Whether parameter ``name`` lies under a module a pattern matches."""
    names = name.split(".")
    mods = names[:-1] if len(names) > 1 else names
    return any(p.search(".".join(mods[:i + 1])) for i in range(len(mods)) for p in patterns)


def layerwise_cast_names(model: nn.Module,
                         skip_patterns: Sequence[str] = DEFAULT_SKIP_PATTERNS) -> List[str]:
    """The frozen floating parameters ``cast_layerwise_storage`` stores in
    float8 (a parameter that trains, a LoRA adapter, is neither cast nor
    skipped). Raises where the patterns skip nothing (JAX's :73-79): every floating
    parameter would be float8 and the compute dtype unrecoverable."""
    pats = [re.compile(p) for p in skip_patterns if p]
    cast, kept = [], 0
    for name, p in model.named_parameters():
        if not p.is_floating_point() or p.requires_grad:  # what trains keeps its dtype
            continue
        if skipped(name, pats):
            kept += 1
        else:
            cast.append(name)
    if cast and not kept:
        raise ValueError(
            "layerwise_upcasting skip patterns matched no module: every floating parameter "
            "would be stored in float8 and the model's compute dtype would be unrecoverable. "
            f"Check --layerwise_upcasting_skip_modules_pattern (got {list(skip_patterns)!r}).")
    return cast


def cast_layerwise_storage(model: nn.Module, storage_dtype="float8_e4m3fn",
                           skip_patterns: Sequence[str] = DEFAULT_SKIP_PATTERNS) -> List[str]:
    """Store the frozen parameters of ``layerwise_cast_names`` in
    ``storage_dtype`` in place, and make every ``nn.Linear`` holding one
    upcast it at use (``lora.Float8Linear``). Returns the cast names."""
    from .lora import Float8Linear

    dt = STORAGE_DTYPES[storage_dtype] if isinstance(storage_dtype, str) else storage_dtype
    compute = compute_dtype(model)
    names = layerwise_cast_names(model, skip_patterns)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name in names:
            params[name].data = params[name].data.to(dt)
    for module in model.modules():
        if type(module) is nn.Linear and module.weight.dtype in FLOAT8_DTYPES:
            module.__class__ = Float8Linear
            module.compute_dtype = compute
    return names
