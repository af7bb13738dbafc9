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

``write_precomputed`` writes the same layout, for data made without the
encoders (random latents at a given shape, or Hunyuan latents from
``prepare_latents``). Decoding, bucketing and the text-encoder and VAE
precompute pass itself are not ported.
"""

from __future__ import annotations

import ast
import json
import os
from typing import Any, Dict, Iterable, Iterator, Tuple

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
    missing or incomplete: the port has no encoders to fill it."""

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
