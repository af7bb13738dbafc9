"""Experiment trackers: dummy, wandb and a sequence of them.

Port of ``vap_tpu/utils/trackers.py``: ``tracker.timed("timing/...")``
accumulates spans whose means over the logging window join the next
``log()``; ``log_artifacts`` hands over files (the validation videos).
``DummyTracker`` keeps every entry in ``history``; ``WandbTracker`` imports
``wandb`` when it is made, and ``initialize_trackers`` falls back to the
dummy one where that fails, as JAX's does. The spans synchronise the card
(``Timer(synchronize=True)``), so they hold the device work they launched.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Any, Dict, List, Optional

from .timing import Timer

logger = logging.getLogger("vap_tpu_torch.trackers")


class BaseTracker:
    def __init__(self):
        self._timer = Timer(synchronize=True)

    @contextlib.contextmanager
    def timed(self, name: str):
        with self._timer.track(name):
            yield

    def _drain_timings(self) -> Dict[str, float]:
        means = self._timer.means()
        self._timer.reset()
        return means

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None):
        raise NotImplementedError

    def log_artifacts(self, artifacts: Dict[str, Any], step: Optional[int] = None):
        pass

    def finish(self):
        pass


class DummyTracker(BaseTracker):
    def __init__(self):
        super().__init__()
        self.history: List[Dict[str, Any]] = []
        self.artifacts: List[Dict[str, Any]] = []

    def log(self, metrics, step=None):
        entry = dict(metrics)
        entry.update(self._drain_timings())
        if step is not None:
            entry["step"] = step
        self.history.append(entry)

    def log_artifacts(self, artifacts, step=None):
        self.artifacts.append({"step": step, **artifacts})


class WandbTracker(BaseTracker):
    def __init__(self, experiment_name: str, log_dir: str, config: Optional[Dict] = None):
        super().__init__()
        import wandb

        self._wandb = wandb
        self.run = wandb.init(project=experiment_name, dir=log_dir, config=config)

    def log(self, metrics, step=None):
        payload = dict(metrics)
        payload.update(self._drain_timings())
        self._wandb.log(payload, step=step)

    def log_artifacts(self, artifacts, step=None):
        payload = {name: self._wandb.Video(value)
                   if isinstance(value, str) and value.endswith(".mp4") else value
                   for name, value in artifacts.items()}
        if payload:
            self._wandb.log(payload, step=step)

    def finish(self):
        self.run.finish()


class SequentialTracker(BaseTracker):
    def __init__(self, trackers: List[BaseTracker]):
        super().__init__()
        self.trackers = trackers

    @contextlib.contextmanager
    def timed(self, name: str):
        with contextlib.ExitStack() as stack:
            for t in self.trackers:
                stack.enter_context(t.timed(name))
            yield

    def log(self, metrics, step=None):
        for t in self.trackers:
            t.log(metrics, step)

    def log_artifacts(self, artifacts, step=None):
        for t in self.trackers:
            t.log_artifacts(artifacts, step)

    def finish(self):
        for t in self.trackers:
            t.finish()


def initialize_trackers(names, experiment_name: str = "vap_tpu", log_dir: str = "logs",
                        config: Optional[Dict] = None) -> BaseTracker:
    trackers: List[BaseTracker] = []
    for name in names or ["dummy"]:
        if name in ("none", "dummy"):
            trackers.append(DummyTracker())
        elif name == "wandb":
            try:
                trackers.append(WandbTracker(experiment_name, log_dir, config))
            except Exception as e:
                logger.warning("wandb tracker unavailable (%s); logging to the dummy tracker", e)
                trackers.append(DummyTracker())
        else:
            raise ValueError(f"unknown tracker {name!r}")
    return trackers[0] if len(trackers) == 1 else SequentialTracker(trackers)
