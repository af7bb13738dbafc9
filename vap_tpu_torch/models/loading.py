"""Checkpoint weights -> the port's modules, one tensor at a time.

The port's modules carry the diffusers / HF names and the torch layouts of
the checkpoints (``convert.py``), so one helper loads every component: the
CogVideoX and Wan transformers (MoT or plain), HunyuanVideo's transformer,
the three VAEs, T5 / UMT5, CLIP vision and text, and LLaMA. ``load_model``
builds the module on the meta device, allocates it on the card (or in host
memory), and copies each tensor of its state dict out of the checkpoint
mapping (``utils.safetensors.SafetensorsDict``: views of the mapped files),
cast to the component's dtype, in the module's order. The host never holds
a copy of the weights: what it reads are the mapped files' pages, which the
mapping gives back when the component's mapping is closed (on the card's
sandboxed kernel they count in the process's resident memory until then;
reading in the files' own order was 4-5x slower there).

The keys read are exactly those the JAX package's converter of that
component reads (``vap_tpu/models/*/weights.py``, ``vae_weights.py``,
``convert_*_state_dict``): the module's state dict, each key read from the
first present of the names the module's ``checkpoint_aliases`` give it
(T5's embedding from ``shared.weight`` or else
``encoder.embed_tokens.weight``, as ``convert_t5_state_dict`` takes it).
Every other key of the checkpoint is ignored (diffusers' non-persistent
tables, T5's tied ``encoder.embed_tokens.weight`` beside ``shared.weight``).
A missing key raises ``KeyError``, a wrong shape ``ValueError``, both before
any copy.

No module of the port has a non-persistent buffer (W8A8's buffers come
with ``quantize_transformer_linears``, after loading), so ``to_empty``
leaves nothing uninitialised; ``load_state_`` raises if that changes.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict

import torch
from torch import nn


def build_on_meta(cls, cfg, dtype: torch.dtype) -> nn.Module:
    """``cls(cfg)`` on the meta device, its floating tensors in ``dtype``."""
    prev = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        with torch.device("meta"):
            return cls(cfg)
    finally:
        torch.set_default_dtype(prev)


def checkpoint_keys(model: nn.Module, state: Mapping) -> Dict[str, str]:
    """{state-dict key of ``model``: the checkpoint key it is read from}.
    Raises ``KeyError`` for a missing key and ``ValueError`` for a wrong
    shape."""
    aliases = getattr(model, "checkpoint_aliases", {})
    plan = {}
    for name, t in model.state_dict(keep_vars=True).items():
        key = next((k for k in aliases.get(name, (name,)) if k in state), None)
        if key is None:
            raise KeyError(f"{type(model).__name__}: the checkpoint has no {name!r}")
        shape = tuple(state[key].shape)  # a view of a mapped file reads nothing
        if shape != tuple(t.shape):
            raise ValueError(f"{type(model).__name__}: {key!r} has shape {shape}, "
                             f"the model {tuple(t.shape)}")
        plan[name] = key
    return plan


def load_state_(model: nn.Module, state: Mapping) -> nn.Module:
    """Copy ``model``'s whole state dict out of ``state`` in place, each
    tensor cast to its parameter's dtype and device."""
    persistent = set(model.state_dict(keep_vars=True))
    unsaved = [n for n, _ in list(model.named_parameters()) + list(model.named_buffers())
               if n not in persistent]
    if unsaved:
        raise RuntimeError(f"{type(model).__name__}: {unsaved[:4]} are not in the state dict, "
                           f"so loading would leave them uninitialised")
    plan = checkpoint_keys(model, state)
    targets = model.state_dict(keep_vars=True)
    with torch.no_grad():
        for name, key in plan.items():
            targets[name].copy_(state[key])
    return model


def load_model(cls, cfg, state: Mapping, device, dtype: torch.dtype,
               host: bool = False) -> nn.Module:
    """``cls(cfg)`` with the weights of ``state`` in ``dtype``, on ``device``
    (in host memory with ``host``: the pipelines' model offload), in eval
    mode."""
    model = build_on_meta(cls, cfg, dtype)
    model.to_empty(device="cpu" if host else device)
    return load_state_(model, state).eval()
