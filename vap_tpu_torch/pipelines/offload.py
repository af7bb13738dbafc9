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
    components in ``COMPONENTS`` and, where it streams, its transformer's
    block list in ``BLOCKS``, and holds ``device``,
    ``enable_model_offload``, ``stage_seconds`` (host-clock seconds per
    stage) and ``_staged`` (the one-component slot); one that streams holds
    ``offload_blocks_chunk``, ``_pinned`` (the blocks' page-locked host
    tensors) and ``_streamed`` (the runner)."""

    COMPONENTS: ClassVar[Tuple[str, ...]] = ()
    BLOCKS: ClassVar[str] = ""

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _unstage(self) -> None:
        """Put the staged component, if any, back in host memory."""
        if self._staged:
            _unstage(self._staged)
            if self.device.type == "cuda":
                torch.cuda.empty_cache()

    def pinned_blocks(self):
        """The transformer's blocks in chunks of ``offload_blocks_chunk``,
        their host pages locked in place on a card, built on first use and
        again when the chunk size changed or a block tensor was replaced
        (``pipelines/streamed.py``). Anything staged goes back to the host
        first: the blocks' own host tensors are what is locked."""
        from .streamed import PinnedBlocks, block_chunks

        self._unstage()
        chunks = block_chunks(self.transformer.config, self.offload_blocks_chunk)
        store = self._pinned
        if store is None or store.chunks != chunks or not store.current():
            self.close_streamed()
            self._pinned = PinnedBlocks(getattr(self.transformer, self.BLOCKS), chunks,
                                        pin=self.device.type == "cuda")
        return self._pinned

    def streamed_runner(self):
        """The streamed runner of the current store (one for every branch
        mode and reference count: the chunks are the store's, the slots the
        runner's)."""
        from .streamed import StreamedTransformer

        store = self.pinned_blocks()
        if self._streamed is None or self._streamed.store is not store:
            self._streamed = StreamedTransformer(self.transformer, store, self.device)
        return self._streamed

    def close_streamed(self) -> None:
        """Drop the streamed runner and unlock the blocks' host pages: before
        the blocks are staged whole (a resident call does it first), moved or
        replaced (``quantize_transformer_linears``), since a copy from a
        partly locked range fails."""
        if self._streamed is not None:
            self._streamed.release()
            self._streamed = None
        if self._pinned is not None:
            self._pinned.close()
            self._pinned = None

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
