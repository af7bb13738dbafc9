"""A host thread that prefetches samples, with checkpointable state.

Port of ``vap_tpu/data/dataloader.py`` ``PrefetchingDataLoader`` (:16): a
worker thread decodes and preprocesses ``prefetch`` samples ahead of the
consumer; ``state_dict`` is the dataset's state as of the last sample the
consumer took (not the prefetch position), so a checkpoint resumes at the
next unconsumed sample. ``close`` stops the thread and drops the samples
it holds (a run's end: they would otherwise stay in host memory).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Optional


class PrefetchingDataLoader:
    _SENTINEL = object()

    def __init__(self, dataset, prefetch: int = 4):
        self.dataset = dataset
        self.prefetch = prefetch
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._error = None
        self._consumed_state = None
        self._stop = threading.Event()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def _worker(self):
        try:
            for sample in self.dataset:
                # the dataset's state right after it made this sample
                state = self.dataset.state_dict() if hasattr(self.dataset, "state_dict") else None
                if not self._put((sample, state)):
                    return
        except Exception as e:  # raised again on the consumer's side
            self._error = e
        self._put(self._SENTINEL)

    def close(self) -> None:
        """Stop the worker thread and drop what it prefetched."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._queue = None

    def __iter__(self) -> Iterator[Any]:
        self._stop.clear()
        self._queue = queue.Queue(maxsize=self.prefetch)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        while True:
            item = self._queue.get()
            if item is self._SENTINEL:
                if self._error is not None:
                    raise self._error
                return
            sample, state = item
            if state is not None:
                self._consumed_state = state
            yield sample

    def state_dict(self) -> Dict[str, Any]:
        if self._consumed_state is not None:
            return {"dataset": self._consumed_state}
        if hasattr(self.dataset, "state_dict"):
            return {"dataset": self.dataset.state_dict()}
        return {}

    def load_state_dict(self, state: Dict[str, Any]):
        if "dataset" in state and hasattr(self.dataset, "load_state_dict"):
            self.dataset.load_state_dict(state["dataset"])
