"""Named, accumulating timers.

Port of ``vap_tpu/utils/timing.py`` ``Timer`` (:16): ``with
timer.track("forward"): ...`` adds the span's host-clock seconds to its
name; with ``synchronize`` the card is synchronised at both ends, so the
span holds the device work it launched.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

import torch


class Timer:
    def __init__(self, synchronize: bool = False):
        self.synchronize = synchronize
        self._totals: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def track(self, name: str):
        if self.synchronize:
            self._sync()
        start = time.perf_counter()
        try:
            yield
        finally:
            if self.synchronize:
                self._sync()
            self._totals[name] += time.perf_counter() - start
            self._counts[name] += 1

    @staticmethod
    def _sync():
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def means(self) -> Dict[str, float]:
        return {k: self._totals[k] / max(self._counts[k], 1) for k in self._totals}

    def reset(self):
        self._totals.clear()
        self._counts.clear()
