"""LoRA adapters over a frozen model's linears.

Port of ``vap_tpu/training/lora.py``. An adapter tree is a dict
``{module name: {"A": [in, r], "B": [r, out]}}`` in float32, one entry per
targeted ``nn.Linear``, in the JAX package's layout (A and B of a kernel
[in, out]). ``init_lora`` draws it (A ~ N(0, 1) * fan_in^-1/2, B = 0, so the
adapted model starts equal to the base); ``apply_lora`` installs it;
``merge_lora_into_params`` bakes it into a state dict for export;
``lora_bypassed`` runs the model on its frozen base alone (DPO's reference
pass).

The function is JAX's ``apply_lora``: each targeted linear runs with the
merged weight W + ((alpha / r) * A @ B)^T cast to W's dtype, formed inside
its forward, so under block remat the merged weight lives only while its
block runs. Autograd then forms one full-size weight gradient per adapted
linear before it reaches A and B, as ``jax.grad`` of the merge does. (The
side-branch form x W^T + (alpha / r) x A B is cheaper but rounds
differently in bf16; it is not this function.)

Float8 storage of the frozen base (``training/layerwise.py``): a
``LoRALinear`` over a float8 weight merges W upcast to the compute dtype
(``layerwise.compute_dtype``, JAX's ``_non_storage_dtype``) plus the delta,
as JAX's ``apply_lora`` upcasts a float8 leaf before the merge; every other
frozen linear holding float8 becomes a ``Float8Linear``, which upcasts its
weight and bias inside its forward and keeps only the float8 weight for the
backward. Either way the upcast copy lives while its linear runs (under
block remat it is not kept for the backward of every block).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, Iterator, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

DEFAULT_TARGETS = ("to_q", "to_k", "to_v", "to_out", "net_0", "net_2")
# the JAX package's projection names -> the ends of the port's module names
# (diffusers keys: to_out.0, ff.net.0.proj, ff.net.2)
MODULE_SUFFIX = {"to_q": "to_q", "to_k": "to_k", "to_v": "to_v", "to_out": "to_out.0",
                  "net_0": "net.0.proj", "net_2": "net.2"}
_FLOAT8 = (torch.float8_e4m3fn, torch.float8_e5m2)


def _upcast(x: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return x.to(dtype) if x is not None and x.dtype in _FLOAT8 else x


class _Float8LinearFunction(torch.autograd.Function):
    """y = x W^T + b with W and b stored in float8 and upcast to ``dtype``
    here; the backward gives x's gradient from W upcast again (W and b are
    frozen), so no upcast copy is kept between the two."""

    @staticmethod
    def forward(ctx, x, weight, bias, dtype):
        ctx.save_for_backward(weight)
        ctx.dtype = dtype
        return F.linear(x, weight.to(dtype), _upcast(bias, dtype))

    @staticmethod
    def backward(ctx, grad):
        (weight,) = ctx.saved_tensors
        return grad.matmul(weight.to(ctx.dtype)), None, None, None


class Float8Linear(nn.Linear):
    """A frozen ``nn.Linear`` whose weight (and bias) are float8 storage,
    upcast to ``compute_dtype`` inside the forward (``cast_layerwise_storage``
    gives a linear this class in place)."""

    compute_dtype: torch.dtype = torch.bfloat16

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() and x.requires_grad:
            return _Float8LinearFunction.apply(x, self.weight, self.bias, self.compute_dtype)
        return F.linear(x, _upcast(self.weight, self.compute_dtype),
                        _upcast(self.bias, self.compute_dtype))

LoRATree = Dict[str, Dict[str, torch.Tensor]]


class LoRALinear(nn.Module):
    """A frozen ``nn.Linear`` (its ``weight`` and ``bias``, the same
    parameters) with an adapter: y = x W'^T + bias, W' = W + ((scale A B)^T)
    in W's dtype. ``lora_A`` [in, r] and ``lora_B`` [r, out] train. With
    ``bypass`` set the adapter is off: y = x W^T + bias."""

    def __init__(self, base: nn.Linear, a: torch.Tensor, b: torch.Tensor, scale: float,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = base.weight
        self.bias = base.bias
        self.lora_A = nn.Parameter(a)
        self.lora_B = nn.Parameter(b)
        self.scale = scale
        self.bypass = False
        # float8 storage is upcast to this dtype at use
        self.compute_dtype = compute_dtype or getattr(base, "compute_dtype", base.weight.dtype)

    def base_weight(self) -> torch.Tensor:
        return _upcast(self.weight, self.compute_dtype)

    def merged_weight(self) -> torch.Tensor:
        delta = (self.lora_A @ self.lora_B) * self.scale
        w = self.base_weight()
        return w + delta.t().to(w.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.base_weight() if self.bypass else self.merged_weight(),
                        _upcast(self.bias, self.compute_dtype))


@contextlib.contextmanager
def lora_bypassed(model: nn.Module) -> Iterator[None]:
    """Within the block every ``LoRALinear`` of ``model`` runs its frozen
    base alone, as JAX's DPO reference pass runs the base tree without
    ``apply_lora`` (train_step.py:499)."""
    modules = [m for m in model.modules() if isinstance(m, LoRALinear)]
    for m in modules:
        m.bypass = True
    try:
        yield
    finally:
        for m in modules:
            m.bypass = False


def target_names(model: nn.Module, targets: Sequence[str] = DEFAULT_TARGETS,
                 mot_only: bool = False) -> list:
    """Names of the ``nn.Linear`` modules the JAX ``_is_target`` selects:
    those whose projection name is in ``targets``; with ``mot_only``, only
    those of the MoT expert (``_mot_ref`` in the name)."""
    suffixes = tuple("." + MODULE_SUFFIX[t] for t in targets)
    return [name for name, mod in model.named_modules()
            if isinstance(mod, nn.Linear) and ("." + name).endswith(suffixes)
            and (not mot_only or "_mot_ref" in name)]


def init_lora(model: nn.Module, rank: int = 64, targets: Sequence[str] = DEFAULT_TARGETS,
              mot_only: bool = True, generator: Optional[torch.Generator] = None,
              dtype: torch.dtype = torch.float32) -> LoRATree:
    """The adapter tree of ``init_lora``: for every target linear, A [in, r]
    ~ N(0, 1) * in^-1/2 and B [r, out] = 0, on the linear's device, drawn from
    ``generator`` in module order."""
    lora: LoRATree = {}
    for name in target_names(model, targets, mot_only):
        w = model.get_submodule(name).weight
        fan_out, fan_in = w.shape
        a = torch.randn((fan_in, rank), generator=generator, device=w.device, dtype=dtype)
        lora[name] = {"A": a * fan_in ** -0.5,
                      "B": torch.zeros((rank, fan_out), device=w.device, dtype=dtype)}
    return lora


def apply_lora(model: nn.Module, lora: LoRATree, alpha: float = 64.0,
               rank: int = 64) -> LoRATree:
    """Install ``lora`` in ``model`` in place: each named linear becomes a
    ``LoRALinear`` over the same weight and bias, with the adapter's tensors
    as its trainable ``lora_A`` and ``lora_B``. Returns the tree of those
    parameters."""
    from .layerwise import compute_dtype

    scale = alpha / rank
    compute = compute_dtype(model)
    installed: LoRATree = {}
    for name, ab in lora.items():
        base = model.get_submodule(name)
        if not isinstance(base, nn.Linear):
            raise ValueError(f"LoRA target {name!r} is a {type(base).__name__}, not a Linear")
        parent, _, attr = name.rpartition(".")
        module = LoRALinear(base, ab["A"], ab["B"], scale,
                            compute if base.weight.dtype in _FLOAT8 else None)
        setattr(model.get_submodule(parent) if parent else model, attr, module)
        installed[name] = {"A": module.lora_A, "B": module.lora_B}
    return installed


def lora_param_count(lora: LoRATree) -> int:
    return sum(x.numel() for ab in lora.values() for x in ab.values())


def merge_lora_into_params(params: Dict[str, torch.Tensor], lora: LoRATree, alpha: float = 64.0,
                           rank: int = 64) -> Dict[str, torch.Tensor]:
    """Bake adapters into a state dict of the base weights (for export): each
    targeted ``<name>.weight`` becomes W + ((alpha / r) A B)^T in W's dtype;
    adapter keys (``lora_A``, ``lora_B``) are dropped. Float8 storage is
    upcast to the state's compute dtype first, every such entry (JAX's
    ``apply_lora`` upcasts every float8 leaf)."""
    scale = alpha / rank
    out = {k: v for k, v in params.items() if not k.endswith((".lora_A", ".lora_B"))}
    compute = next((v.dtype for v in out.values()
                    if v.is_floating_point() and v.dtype not in _FLOAT8), torch.bfloat16)
    out = {k: _upcast(v, compute) for k, v in out.items()}
    with torch.no_grad():
        for name, ab in lora.items():
            w = out[f"{name}.weight"]
            delta = (ab["A"].to(w.device) @ ab["B"].to(w.device)) * scale
            out[f"{name}.weight"] = w + delta.t().to(w.dtype)
    return out


def lora_parameters(lora: LoRATree) -> Iterable[torch.Tensor]:
    """A, then B, of every adapter, in tree order (the optimizer's order)."""
    for ab in lora.values():
        yield ab["A"]
        yield ab["B"]
