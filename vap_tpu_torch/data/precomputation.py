"""Replay of the precomputed (condition, latent) ``.npz`` cache.

The port's copy of the reader of ``vap_tpu/data/precomputation.py``
(``_load_npz``, :25-33, and ``PrecomputedPreprocessor.__iter__``): the JAX
trainer's precompute pass writes ``rank_<r>/cond_<i>.npz`` and
``lat_<i>.npz`` per item, with a ``manifest.json`` once the pass is
complete, so the text encoder and the VAE stay off the card while training.
Each ``.npz`` holds the item's arrays and a ``__meta__`` entry, the ``repr``
of a dict of its other values, read back with ``ast.literal_eval``.

The keys are those of each family's ``prepare_conditions`` and
``prepare_latents``. CogVideoX (``CogVideoXSpec``,
``vap_tpu/training/specs.py:187-246``): condition ``encoder_hidden_states``
[1, T, D_text] and ``encoder_hidden_states_mot_ref`` [1, R*T, D_text];
latent ``latents``, ``image_latents`` [1, F, C, h, w] and
``latents_mot_ref``, ``image_latents_mot_ref`` [1, R*F, C, h, w],
VAE-scaled. Wan (``WanSpec``, specs.py:605-669), channel-last and
mean/std-normalised: condition ``encoder_hidden_states`` [1, 512, 4096]
(UMT5, zero past the prompt) and, for I2V, ``encoder_hidden_states_image``
[1, 257, 1280] (CLIP); latent ``latents`` [1, 13, 60, 104, 16] at 49f@480x832
and, for I2V, ``condition`` [1, 13, 60, 104, 20] (the 4-channel first-frame
mask and the 16-channel latent of the first frame then zeros); a VAP item
adds ``*_mot_ref`` entries of the same layouts. A plain (non-VAP) item has
no ``*_mot_ref`` entry and trains the trunk alone. HunyuanVideo
(``HunyuanVideoSpec``, specs.py:304-395): condition
``encoder_hidden_states`` [1, 256, 4096] (LLaMA hidden state -3, the
template's first 95 tokens cropped), ``prompt_attention_mask`` [1, 256]
(float32, a right-padded prefix of ones) and ``pooled_projections``
[1, 768] (CLIP-L); latent ``latents`` [1, 16, F, H, W], channel-first and
VAE-scaled (unlike Wan's channel-last), 13 x 60 x 96 at 49f@480x768, as
``models/hunyuan_video/vae.py`` ``prepare_latents`` makes them.

``PrecomputedPreprocessor`` is the port of JAX's precompute pass
(``vap_tpu/data/precomputation.py:55``): ``precompute`` (:118) runs the
encoders over the data stream and writes that layout, with the manifest
``{complete, count, rank, world_size, signature}``; ``is_cached`` (:114)
accepts a cache only when every rank's manifest is complete, was written
under this world size and this run's signature, and counts the files on
disk, so a cache written under other settings is recomputed, never
replayed. Caches are shared with JAX both ways. ``InMemoryPreprocessor``
(:35) buffers ``num_items`` encoded pairs in host memory instead.
``write_precomputed`` writes the same layout for data made without the
encoders (random latents at a given shape, say).
"""

from __future__ import annotations

import ast
import json
import os
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

MANIFEST = "manifest.json"
Pair = Tuple[Dict[str, Any], Dict[str, Any]]


def _save_npz(path: str, data: Dict[str, Any]) -> None:
    arrays = {k: v for k, v in data.items() if isinstance(v, np.ndarray)}
    meta = {k: v for k, v in data.items() if not isinstance(v, np.ndarray)}
    np.savez(path, __meta__=np.asarray(repr(meta)), **arrays)


def _load_npz(path: str) -> Dict[str, Any]:
    with np.load(path, allow_pickle=False) as z:
        out = {k: z[k] for k in z.files if k != "__meta__"}
        if "__meta__" in z.files:
            out.update(ast.literal_eval(str(z["__meta__"])))
    return out


def write_precomputed(directory: str, pairs: Iterable[Pair], rank: int = 0) -> int:
    """Write (condition, latent) pairs as a complete one-rank cache in the
    JAX trainer's layout; returns the item count."""
    d = os.path.join(directory, f"rank_{rank}")
    os.makedirs(d, exist_ok=True)
    count = 0
    for cond, lat in pairs:
        _save_npz(os.path.join(d, f"cond_{count:06d}.npz"), cond)
        _save_npz(os.path.join(d, f"lat_{count:06d}.npz"), lat)
        count += 1
    with open(os.path.join(d, MANIFEST), "w") as fh:
        json.dump({"complete": True, "count": count, "rank": rank, "world_size": 1,
                   "signature": None}, fh)
    return count


class PrecomputedReader:
    """The items of one rank's cache, in file order. Raises when the cache is
    missing or incomplete (a trainer without encoders cannot fill it)."""

    def __init__(self, directory: str, rank: int = 0):
        self.dir = os.path.join(directory, f"rank_{rank}")
        try:
            with open(os.path.join(self.dir, MANIFEST)) as fh:
                manifest = json.load(fh)
        except (OSError, ValueError) as e:
            raise FileNotFoundError(f"no complete precomputed cache in {self.dir}: {e}") from None
        self.names = sorted(f[len("cond_"):-len(".npz")] for f in os.listdir(self.dir)
                            if f.startswith("cond_") and f.endswith(".npz"))
        if not manifest.get("complete") or manifest.get("count") != len(self.names):
            raise ValueError(f"precomputed cache in {self.dir} is incomplete: manifest "
                             f"{manifest}, {len(self.names)} items on disk")
        if not self.names:
            raise ValueError(f"precomputed cache in {self.dir} holds no item")

    def __len__(self) -> int:
        return len(self.names)

    def item(self, i: int) -> Pair:
        """Item ``i`` of the endless replay (the cache's item ``i mod len``)."""
        name = self.names[i % len(self.names)]
        return (_load_npz(os.path.join(self.dir, f"cond_{name}.npz")),
                _load_npz(os.path.join(self.dir, f"lat_{name}.npz")))

    def stream(self, start: int = 0) -> Iterator[Pair]:
        """The cache replayed forever, as the JAX trainer replays it, from
        item ``start`` of that endless stream (a resumed run's position)."""
        i = start
        while True:
            yield self.item(i)
            i += 1


class InMemoryPreprocessor:
    """Encode ``num_items`` samples at a time into host memory."""

    def __init__(self, data_iter: Iterator, prepare_conditions: Callable,
                 prepare_latents: Callable, num_items: int = 8):
        self._iter = data_iter
        self._prepare_conditions = prepare_conditions
        self._prepare_latents = prepare_latents
        self.num_items = num_items
        self._buffer: List[Pair] = []

    def consume(self) -> List[Pair]:
        self._buffer = []
        for _ in range(self.num_items):
            sample = next(self._iter)
            self._buffer.append((self._prepare_conditions(sample), self._prepare_latents(sample)))
        return self._buffer


class PrecomputedPreprocessor:
    """Write each rank's encoded (condition, latent) pairs once (the replay
    is ``PrecomputedReader``'s); reuse is gated on every rank's manifest
    (``is_cached``)."""

    MANIFEST = MANIFEST

    def __init__(self, directory: str, rank: int = 0, world_size: int = 1, reuse: bool = True,
                 signature: Optional[Dict[str, Any]] = None):
        self.root = directory
        self.rank = rank
        self.world_size = max(1, world_size)
        self.signature = signature
        self.dir = os.path.join(directory, f"rank_{rank}")
        os.makedirs(self.dir, exist_ok=True)
        self.reuse = reuse

    def _rank_dir(self, rank: int) -> str:
        return os.path.join(self.root, f"rank_{rank}")

    def _npz_counts(self, rank: int) -> Dict[str, int]:
        d = self._rank_dir(rank)
        names = os.listdir(d) if os.path.isdir(d) else []
        return {kind: sum(1 for f in names if f.startswith(kind + "_") and f.endswith(".npz"))
                for kind in ("cond", "lat")}

    def _rank_complete(self, rank: int) -> bool:
        try:
            with open(os.path.join(self._rank_dir(rank), MANIFEST)) as f:
                m = json.load(f)
        except (OSError, ValueError):
            return False
        if not m.get("complete") or m.get("world_size") != self.world_size:
            return False  # another world size shards the data otherwise
        if self.signature is not None and m.get("signature") != self.signature:
            return False
        counts = self._npz_counts(rank)
        return counts["cond"] == counts["lat"] == m.get("count")

    def is_cached(self) -> bool:
        return self.reuse and all(self._rank_complete(r) for r in range(self.world_size))

    def precompute(self, data_iter: Iterator, prepare_conditions: Callable,
                   prepare_latents: Callable, max_items: Optional[int] = None) -> int:
        """Encode the stream (up to ``max_items``) into this rank's files,
        the stale ones removed first; the manifest is written last."""
        for f in os.listdir(self.dir):
            if f.endswith(".npz") or f == MANIFEST:
                os.remove(os.path.join(self.dir, f))
        count = 0
        for sample in data_iter:
            cond = prepare_conditions(sample)
            lat = prepare_latents(sample)
            _save_npz(os.path.join(self.dir, f"cond_{count:06d}.npz"), cond)
            _save_npz(os.path.join(self.dir, f"lat_{count:06d}.npz"), lat)
            count += 1
            if max_items and count >= max_items:
                break
        manifest = {"complete": True, "count": count, "rank": self.rank,
                    "world_size": self.world_size, "signature": self.signature}
        tmp = os.path.join(self.dir, MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, os.path.join(self.dir, MANIFEST))
        return count
