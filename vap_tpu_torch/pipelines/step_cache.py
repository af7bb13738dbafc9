"""Denoise-step caching schedules: the port's copy of the numpy parsers of
``vap_tpu/pipelines/step_cache.py:45-105``.

The step cache keeps the raw CFG-batch model output and reuses it on
scheduled steps, skipping whole transformer forwards; the scheduler still
advances every step and CFG is recombined with each step's own guidance.

Specs:

- "uniform:N[:warmup[:cooldown]]" computes the forward on the first
  `warmup` steps (default 5), the last `cooldown` (default 5) and every Nth
  step in between.
- "adaptive:THRESH[:warmup[:cooldown]]" (TeaCache-style) accumulates the
  relative L1 change of the denoise input latents since the last computed
  step and computes once it reaches THRESH; warmup and cooldown steps always
  compute. The decision is taken at run time.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class StepCacheSpec:
    kind: str          # "uniform" | "adaptive"
    # uniform: the compute mask. adaptive: the FORCED mask (warmup/cooldown
    # steps that always compute); in-between steps decide at runtime.
    mask: np.ndarray
    thresh: float = 0.0  # adaptive only


def parse_step_cache(spec: Optional[str], num_steps: int) -> Optional[StepCacheSpec]:
    """spec string -> StepCacheSpec, or None when spec is None/'none'."""
    if spec is None or spec == "none":
        return None
    parts = spec.split(":")
    if parts[0] == "uniform":
        return StepCacheSpec("uniform", parse_step_cache_schedule(spec, num_steps))
    if parts[0] != "adaptive" or len(parts) < 2 or len(parts) > 4:
        raise ValueError(
            f"unknown step_cache spec {spec!r}; expected "
            "'uniform:N[:warmup[:cooldown]]' or 'adaptive:THRESH[:warmup[:cooldown]]'")
    thresh = float(parts[1])
    warmup = int(parts[2]) if len(parts) > 2 else 5
    cooldown = int(parts[3]) if len(parts) > 3 else 5
    if thresh < 0 or warmup < 1 or cooldown < 0:
        raise ValueError(
            f"invalid step_cache spec {spec!r}: need THRESH>=0, warmup>=1, cooldown>=0")
    if num_steps < 1:
        raise ValueError(f"step_cache needs num_inference_steps >= 1 (got {num_steps})")
    idx = np.arange(num_steps)
    forced = (idx < warmup) | (idx >= num_steps - cooldown)
    forced[0] = True
    return StepCacheSpec("adaptive", forced, thresh)


def parse_step_cache_schedule(spec: Optional[str], num_steps: int) -> Optional[np.ndarray]:
    """UNIFORM spec -> bool[num_steps] compute mask (True = run the
    transformer), or None when spec is None/'none'. Step 0 is always computed
    (nothing cached yet); the parser guarantees it. Adaptive specs have no
    static mask — use parse_step_cache for those."""
    if spec is None or spec == "none":
        return None
    parts = spec.split(":")
    if parts[0] == "adaptive":
        raise ValueError(
            f"step_cache spec {spec!r} has no static schedule (the computed "
            "steps are decided at runtime); use parse_step_cache")
    if parts[0] != "uniform" or len(parts) < 2 or len(parts) > 4:
        raise ValueError(
            f"unknown step_cache spec {spec!r}; expected 'uniform:N[:warmup[:cooldown]]'"
            " or 'adaptive:THRESH[:warmup[:cooldown]]'")
    n = int(parts[1])
    warmup = int(parts[2]) if len(parts) > 2 else 5
    cooldown = int(parts[3]) if len(parts) > 3 else 5
    if n < 1 or warmup < 1 or cooldown < 0:
        raise ValueError(f"invalid step_cache spec {spec!r}: need N>=1, warmup>=1, cooldown>=0")
    if num_steps < 1:
        raise ValueError(f"step_cache needs num_inference_steps >= 1 (got {num_steps})")
    idx = np.arange(num_steps)
    mask = (idx < warmup) | (idx >= num_steps - cooldown) | ((idx - warmup) % n == 0)
    mask[0] = True
    return mask


class StepCacheSchedule:
    """The denoise loops' per-step decision for one call: ``compute(i,
    latents)`` says whether step ``i`` runs the transformer on its input
    ``latents``. Without a spec every step computes; "uniform" reads the
    mask; "adaptive" accumulates the relative L1 change of the inputs since
    the last computed step (float32 on the latents' device, as the JAX scan
    carries it, ``cogvideox_i2v_mot.py:285-301``) and decides on the host."""

    def __init__(self, spec: Optional[StepCacheSpec]):
        self.spec = spec
        self.prev = None
        self.accum = None

    def compute(self, i: int, latents: torch.Tensor) -> bool:
        spec = self.spec
        if spec is None:
            return True
        if spec.kind == "uniform":
            return bool(spec.mask[i])
        if self.prev is None:
            self.prev = latents
            self.accum = torch.zeros((), dtype=torch.float32, device=latents.device)
        d = (latents - self.prev).abs().mean() / (self.prev.abs().mean() + 1e-8)
        self.accum = self.accum + d
        compute = bool(spec.mask[i]) or bool(self.accum >= spec.thresh)
        if compute:
            self.accum = torch.zeros_like(self.accum)
        self.prev = latents
        return compute
