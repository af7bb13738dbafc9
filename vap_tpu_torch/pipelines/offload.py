"""Module-level weight offload for the inference pipelines.

Port of ``vap_tpu/pipelines/offload.py:28-41``. With offload on, every
component's weights stay in host memory and exactly one component at a time
is staged onto the card for its stage (text encoder, image encoder, VAE,
transformer), so the peak is the largest component plus its activations
rather than the sum of all of them. As in JAX, staging makes a device copy
and leaves the host weights as they are: putting a component back is a
pointer swap to its host tensors, with no copy back, since inference never
writes a weight.
"""

from __future__ import annotations

import time
from typing import ClassVar, Dict, List, Tuple

import torch
from torch import nn


def _tensors(module: nn.Module):
    yield from module.parameters()
    yield from module.buffers()


def _unstage(slot: List[Tuple[str, nn.Module, list]]) -> None:
    for _, module, host in slot:
        for t, h in zip(_tensors(module), host):
            t.data = h
    slot.clear()


def stage_component(components: Dict[str, nn.Module], name: str,
                    slot: List[Tuple[str, nn.Module, list]], device: torch.device) -> nn.Module:
    """Return ``components[name]`` with its weights on ``device``, keeping at
    most one staged component in ``slot`` (a 0/1-element list owned by the
    pipeline). A different component staged before is first put back on the
    host, so its device memory is free before the new copy is allocated."""
    if slot and slot[0][0] == name:
        return slot[0][1]
    if slot:
        _unstage(slot)
        if device.type == "cuda":
            torch.cuda.empty_cache()  # hand the freed blocks back before the next copy
    module = components[name]
    host = [t.data for t in _tensors(module)]
    with torch.inference_mode(False):  # plain tensors, even when called from inference
        for t in _tensors(module):
            t.data = t.data.to(device)
    slot.append((name, module, host))
    return module


class StagedComponents:
    """What the inference pipelines share of offload. A pipeline names its
    components in ``COMPONENTS`` and holds ``device``,
    ``enable_model_offload``, ``stage_seconds`` (host-clock seconds per
    stage) and ``_staged`` (the one-component slot)."""

    COMPONENTS: ClassVar[Tuple[str, ...]] = ()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _component(self, name: str) -> nn.Module:
        """The component ``name``: the resident module, or under
        ``enable_model_offload`` the module staged onto ``device`` (one
        component at a time), the seconds of the copy added to
        ``stage_seconds["staging"][name]`` (read after a device
        synchronise)."""
        if not self.enable_model_offload:
            return getattr(self, name)
        if self._staged and self._staged[0][0] == name:
            return self._staged[0][1]
        self._sync()
        t0 = time.perf_counter()
        module = stage_component({n: getattr(self, n) for n in self.COMPONENTS}, name,
                                 self._staged, self.device)
        self._sync()
        staging = self.stage_seconds.setdefault("staging", {})
        staging[name] = staging.get(name, 0.0) + time.perf_counter() - t0
        return module
