"""Resolution-bucketed batching, copied from ``vap_tpu/data/sampler.py``
(the reference's ResolutionSampler, data/sampler.py:17-60): buffer
(condition, latent) pairs keyed by every array shape, emit a batch when a
bucket fills."""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np


class ResolutionSampler:
    def __init__(self, batch_size: int):
        self.batch_size = batch_size
        self._buckets: Dict[Tuple, List[Tuple[Any, Any]]] = {}
        self._ready_key = None

    def consume(self, condition: Dict[str, Any], latent: Dict[str, Any]):
        # bucket by every array's shape: collate concatenates, and mixed
        # shapes in one bucket would fail mid-training
        def shapes(d):
            return tuple(sorted((k, tuple(np.shape(v))) for k, v in d.items()
                                if hasattr(v, "shape")))

        key = (shapes(latent), shapes(condition))
        self._buckets.setdefault(key, []).append((condition, latent))
        if len(self._buckets[key]) >= self.batch_size:
            self._ready_key = key

    @property
    def is_ready(self) -> bool:
        return self._ready_key is not None

    def get_batch(self) -> Tuple[List[Any], List[Any]]:
        items = self._buckets.pop(self._ready_key)[: self.batch_size]
        self._ready_key = None
        return [c for c, _ in items], [lat for _, lat in items]


def collate_tensor_dicts(dicts: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Concatenate dict-of-array samples along their leading (batch) axis;
    other values become lists."""
    out: Dict[str, Any] = {}
    for k in dicts[0]:
        if hasattr(dicts[0][k], "shape"):
            out[k] = np.concatenate([np.asarray(d[k]) for d in dicts], axis=0)
        else:
            out[k] = [d[k] for d in dicts]
    return out
