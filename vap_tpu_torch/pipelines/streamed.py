"""Streamed block offload for inference: the transformer's block stack
streams through device memory a chunk at a time.

Port of ``vap_tpu/pipelines/streamed.py``, the reference's
``enable_sequential_cpu_offload`` tier (CogVideoX 40 GB -> ~7.5 GB, Wan
64 GB -> ~8 GB). The non-block parameters (embedders and output heads, ~2%
of the weights) are staged onto the device for the whole denoise; the
blocks stay in host memory and are copied in ``chunk_blocks`` at a time,
never across a segment of equal MoT status (``_slice_chunks``, :55-69), so
the peak is the resident part + 2 chunks + activations.

The PyTorch design, not JAX's:

* ``PinnedBlocks`` page-locks the block tensors' host memory where it is
  (``cudaHostRegister``), page by page: the whole pages inside each
  tensor's storage; the bytes before and after them, which share their
  pages with whatever lies there (a copy from a partly locked range
  fails), and the tensors without a whole page are copied once into a
  locked mapping of the store's own, a few MB. No tensor moves and the host
  holds no second copy of the weights; the caching host allocator behind
  ``pin_memory`` would copy each tensor and round its allocation up to a
  power of two. Each chunk's tensors have aligned offsets in a device slot.
* ``StreamedTransformer`` keeps two device slots, each the size of the
  largest chunk, allocated once and reused, so the caching allocator never
  hands a buffer that one stream still uses to the other. Chunks 0 and 1
  are copied on a dedicated copy stream; chunk c's compute waits on its
  copy's event, and the copy of chunk c + 2 into the same slot waits on the
  event recorded after chunk c's compute, so the copy of one chunk
  overlaps the compute of the one before it. The block parameters point
  at the slot's views only while their chunk's kernels are enqueued.
* On the CPU (the tests) the same packing, slots and views run with
  synchronous copies and no stream.

There is no fallback: a buffer that cannot be page-locked raises, and a
streamed call never runs resident. The runner is called with the model's
``forward`` arguments and runs its ``prologue``, ``run_blocks`` per chunk
and ``epilogue``; a reuse step of the step cache calls no forward, so it
streams nothing.
"""

from __future__ import annotations

import ctypes
import mmap
import time
import weakref
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

_ALIGN = 256  # byte offset of every tensor in a chunk buffer


def _tensors(module: nn.Module) -> List[torch.Tensor]:
    return list(module.parameters()) + list(module.buffers())


def block_chunks(cfg, chunk_blocks: int) -> List[List[int]]:
    """The block indices of each chunk: runs of ``chunk_blocks`` within each
    segment of ``cfg.mot_segments`` (``_slice_chunks``)."""
    if chunk_blocks < 1:
        raise ValueError(f"chunk_blocks must be >= 1 (got {chunk_blocks})")
    return [list(range(s, min(s + chunk_blocks, start + length)))
            for start, length, _ in cfg.mot_segments
            for s in range(start, start + length, chunk_blocks)]


def _view(flat: torch.Tensor, offset: int, like: torch.Tensor) -> torch.Tensor:
    nbytes = like.numel() * like.element_size()
    return flat[offset:offset + nbytes].view(like.dtype).view(like.shape)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """The bytes of a contiguous tensor, as uint8 [n]."""
    return t.reshape(-1).view(torch.uint8)


def _reads_pinned(piece: torch.Tensor) -> bool:
    """Whether CUDA takes ``piece``'s memory for page-locked host memory
    (``Tensor.is_pinned`` asks about its storage's first byte)."""
    raw = (ctypes.c_uint8 * piece.numel()).from_address(piece.data_ptr())
    return torch.frombuffer(raw, dtype=torch.uint8).is_pinned()


def _unregister(spans: List[Tuple[int, int]], keep: list) -> None:
    """Unlock ``spans``; ``keep`` (what lies in them) is held until then."""
    cudart = torch.cuda.cudart()
    for a, _ in spans:
        cudart.cudaHostUnregister(a)


class PinnedBlocks:
    """The blocks of ``blocks`` (an ``nn.ModuleList`` in host memory) in
    chunks, each chunk's tensors laid out at aligned offsets of a device
    slot, and the copies that fill a slot.

    No block tensor moves. A tensor is copied in up to three pieces: the
    whole pages inside its storage, from where they are, and the bytes
    before and after them (less than a page each; a tensor without a
    whole page of its own entirely), from a copy in an anonymous mapping
    of the store's own. With ``pin`` those pages and that mapping are
    page-locked (``cudaHostRegister``): every byte copied is locked, and no
    page that holds anything but a block tensor is (a copy from a range
    that is only partly locked fails). The store holds the host tensors
    until ``close``; ``current`` fails once one was replaced or written."""

    def __init__(self, blocks: nn.ModuleList, chunks: List[List[int]], pin: bool):
        self.chunks = chunks
        self.pinned = pin
        page = mmap.PAGESIZE
        t0 = time.perf_counter()
        # per chunk: the block tensors with their data pointers and versions,
        # and the pieces (source bytes, offset in the slot) a copy reads
        self.layouts: Optional[List[List[Tuple[torch.Tensor, int, int]]]] = []
        self.pieces: List[List[Tuple[torch.Tensor, int]]] = []
        self.slot_offsets: List[List[int]] = []
        self.slot_bytes = 0
        edges, spans = [], []  # (host bytes, where their copy goes); whole-page spans
        with torch.no_grad(), torch.inference_mode(False):
            for idx in chunks:
                tensors = [t for i in idx for t in _tensors(blocks[i])]
                if any(t.device.type != "cpu" for t in tensors):
                    raise ValueError("streamed offload needs the blocks in host memory "
                                     "(build the pipeline with enable_model_offload)")
                layout, offsets, pieces, total = [], [], [], 0
                for t in tensors:
                    if not t.data.is_contiguous():
                        t.data = t.data.contiguous()
                    raw = _bytes(t.data)
                    ptr, n = t.data_ptr(), raw.numel()
                    a = min(-(-ptr // page) * page - ptr, n)  # the first whole page
                    b = max((ptr + n) // page * page - ptr, a)  # the end of the last
                    if b > a:
                        pieces.append((raw[a:b], total + a))
                        spans.append((ptr + a, ptr + b))
                    for lo, hi in ((0, a), (b, n)):
                        if hi > lo:
                            edges.append((raw[lo:hi], len(self.pieces), len(pieces)))
                            pieces.append((None, total + lo))
                    layout.append((t, ptr, t._version))
                    offsets.append(total)
                    total += -(-n // _ALIGN) * _ALIGN
                self.layouts.append(layout)
                self.slot_offsets.append(offsets)
                self.pieces.append(pieces)
                self.slot_bytes = max(self.slot_bytes, total)
            # the edges, copied once into a mapping of the store's own
            size = sum(-(-e.numel() // _ALIGN) * _ALIGN for e, _, _ in edges)
            # whole pages: the mapping is locked as a whole
            self._edges = torch.frombuffer(mmap.mmap(-1, max(-(-size // page) * page, page)),
                                           dtype=torch.uint8)
            at = 0
            for e, c, k in edges:
                view = self._edges[at:at + e.numel()]
                view.copy_(e)
                self.pieces[c][k] = (view, self.pieces[c][k][1])
                at += -(-e.numel() // _ALIGN) * _ALIGN
        self.edge_bytes = size
        self.chunk_bytes = [sum(src.numel() for src, _ in pieces) for pieces in self.pieces]
        self.nbytes = sum(self.chunk_bytes)
        self._host = [t.data for layout in self.layouts for t, _, _ in layout]
        self.edge_seconds = time.perf_counter() - t0
        spans.append((self._edges.data_ptr(), self._edges.data_ptr() + self._edges.numel()))
        merged: List[List[int]] = []  # tensors that share a storage share pages
        for a, b in sorted(spans):
            if merged and a < merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.spans = [(a, b) for a, b in merged] if pin else []
        self._finalizer = (weakref.finalize(self, _unregister, self.spans,
                                            [self._host, self._edges]) if pin else None)
        t0 = time.perf_counter()
        cudart = torch.cuda.cudart() if pin else None
        for n, (a, b) in enumerate(self.spans):
            err = int(cudart.cudaHostRegister(a, b - a, 0))
            if err:
                for a2, _ in self.spans[:n]:
                    cudart.cudaHostUnregister(a2)
                self._finalizer.detach()
                raise RuntimeError(f"cudaHostRegister of {b - a} bytes at {a:#x} failed "
                                   f"(cudaError {err})")
        unpinned = [(src.data_ptr(), src.numel()) for pieces in self.pieces
                    for src, _ in pieces if pin and not _reads_pinned(src)]
        if unpinned:
            raise RuntimeError(f"{len(unpinned)} pieces of the block tensors do not read as "
                               f"pinned, e.g. {unpinned[0][1]} bytes at {unpinned[0][0]:#x}")
        self.pin_seconds = time.perf_counter() - t0

    def copy_chunk(self, c: int, slot: torch.Tensor, non_blocking: bool = False) -> None:
        """Chunk c's pieces into ``slot`` (on the current stream)."""
        with torch.inference_mode(False):
            for src, off in self.pieces[c]:
                slot[off:off + src.numel()].copy_(src, non_blocking=non_blocking)

    def views(self, c: int, slot: torch.Tensor):
        """(block tensor, its view in ``slot``) for chunk c's tensors."""
        with torch.inference_mode(False):
            return [(t, _view(slot, off, t)) for (t, _, _), off
                    in zip(self.layouts[c], self.slot_offsets[c])]

    def current(self) -> bool:
        """Whether every block tensor is still the host tensor of the store,
        unwritten since (false once one was replaced or written in place,
        e.g. by ``quantize_transformer_linears`` or ``load_state_dict``, and
        after ``close``)."""
        return self.layouts is not None and all(
            t.data_ptr() == ptr and t._version == version
            for layout in self.layouts for t, ptr, version in layout)

    def close(self) -> None:
        """Unlock the pages and let go of the host tensors (before block
        tensors are moved, replaced or copied to a device outside streaming:
        a copy from a partly locked range fails)."""
        if self._finalizer is not None:
            self._finalizer()
        self.layouts, self.pieces, self._host, self._edges = None, [], [], None


class StreamedTransformer:
    """Callable with the model's ``forward`` arguments, in either branch
    mode; streams the blocks of ``store`` through ``device``; the model's
    other tensors are staged there on the first call until ``release``.
    Counters: ``max_staged`` (chunks on the device at once),
    ``num_forwards``, ``bytes_copied`` (host -> device, all forwards)."""

    def __init__(self, model: nn.Module, store: PinnedBlocks, device):
        self.model = model
        self.store = store
        self.device = torch.device(device)
        self.chunks = store.chunks
        self.max_staged = 0
        self.num_forwards = 0
        self.bytes_copied = 0
        self._resident: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None
        self._slots: Optional[List[torch.Tensor]] = None
        self._stream = None
        # per slot, the event after the last compute that read it
        self._slot_free: List[Optional[torch.cuda.Event]] = [None, None]
        self._events: Optional[Dict] = None

    def _resident_tensors(self) -> List[torch.Tensor]:
        blocks = set(id(t) for layout in self.store.layouts for t, _, _ in layout)
        return [t for t in _tensors(self.model) if id(t) not in blocks]

    def _stage_resident(self) -> None:
        with torch.no_grad(), torch.inference_mode(False):
            self._resident = []
            for t in self._resident_tensors():
                self._resident.append((t, t.data))
                t.data = t.data.to(self.device)
            self._slots = [torch.empty(self.store.slot_bytes, dtype=torch.uint8, device=self.device)
                           for _ in range(min(2, len(self.chunks)))]
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            # the slots' memory may have served kernels still queued on the
            # compute stream: the first copies wait for them
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            self._slot_free = [None, None]

    def release(self) -> None:
        """Put the non-block parameters back in host memory and free the
        slots (the end of the denoise)."""
        if self._resident is None:
            return
        if self._stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(self._stream)
        for t, host in self._resident:
            t.data = host
        self._resident = self._slots = self._stream = None

    def __call__(self, *args, **kwargs):
        if not self.store.current():
            raise RuntimeError("the blocks' tensors are not the ones pinned; build the "
                               "streamed runner again")
        if self._resident is None:
            self._stage_resident()
        model = self.model
        start = None
        if self._stream is not None:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        carry, aux = model.prologue(*args, **kwargs)
        carry = self._stream_blocks(carry, aux, start)
        out, _ = model.epilogue(carry, aux, reference_head=False)
        self.num_forwards += 1
        return out

    def _copy(self, c: int, events: Optional[Dict]) -> None:
        """Chunk c's tensors into slot c % 2: on the copy stream, after the
        compute that last read the slot."""
        slot = self._slots[c % 2]
        if events is None:
            self.store.copy_chunk(c, slot)
        else:
            with torch.cuda.stream(self._stream):
                free = events["compute_done"][c - 2] if c >= 2 else self._slot_free[c]
                if free is not None:
                    self._stream.wait_event(free)
                events["copy_start"][c].record()
                self.store.copy_chunk(c, slot, non_blocking=True)
                events["copy_done"][c].record()
        self.bytes_copied += self.store.chunk_bytes[c]

    def _stream_blocks(self, carry, aux, start):
        n = len(self.chunks)
        cuda = self._stream is not None
        events = None
        if cuda:
            timed = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
            events = {k: [timed() for _ in range(n)]
                      for k in ("copy_start", "copy_done", "compute_start", "compute_done")}
            events["start"], events["prologue_done"] = start, timed()
            events["prologue_done"].record()
        self._events = events
        staged = 0
        for c in range(min(2, n)):
            self._copy(c, events)
            staged += 1
        self.max_staged = max(self.max_staged, staged)
        for c, idx in enumerate(self.chunks):
            views = self.store.views(c, self._slots[c % 2])
            host = [t.data for t, _ in views]
            if cuda:
                torch.cuda.current_stream(self.device).wait_event(events["copy_done"][c])
                events["compute_start"][c].record()
            try:
                for t, view in views:
                    t.data = view
                carry = self.model.run_blocks(carry, aux, start=idx[0], stop=idx[-1] + 1)
            finally:
                for (t, _), h in zip(views, host):
                    t.data = h
            if cuda:
                events["compute_done"][c].record()
                self._slot_free[c % 2] = events["compute_done"][c]
            staged -= 1
            if c + 2 < n:
                self._copy(c + 2, events)
                staged += 1
                self.max_staged = max(self.max_staged, staged)
        return carry

    def copy_stats(self) -> Optional[Dict[str, float]]:
        """The last forward's copy timeline on a card, after a synchronise:
        the copies' milliseconds, the part of them during which the compute
        stream ran (the prologue or a chunk's blocks), and the blocks'
        compute milliseconds. None on the CPU."""
        ev = self._events
        if ev is None:
            return None
        torch.cuda.synchronize(self.device)
        base = ev["start"]
        n = len(self.chunks)
        compute = [(base.elapsed_time(ev["compute_start"][c]),
                    base.elapsed_time(ev["compute_done"][c])) for c in range(n)]
        busy = [(0.0, base.elapsed_time(ev["prologue_done"]))] + compute
        copy_ms = overlap = 0.0
        for c in range(n):
            a, b = base.elapsed_time(ev["copy_start"][c]), base.elapsed_time(ev["copy_done"][c])
            copy_ms += b - a
            overlap += sum(max(0.0, min(b, e) - max(a, s)) for s, e in busy)
        return {"copy_ms": copy_ms, "overlap_ms": overlap,
                "compute_ms": sum(e - s for s, e in compute),
                "blocks_ms": compute[-1][1] - compute[0][0] if n else 0.0}

