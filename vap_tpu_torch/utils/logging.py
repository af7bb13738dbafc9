"""Rank-aware logging: port of ``vap_tpu/utils/logging.py``.

``get_logger(name)`` returns ``logging.getLogger(name)`` with a filter that
silences ranks other than 0 below ERROR unless ``VAP_VERBOSE_LOGS`` is set;
the rank is read when a record is emitted (``torch.distributed``'s once it
is started, else the launcher's ``RANK``), so a logger made at import,
before the process group, silences the right ranks. The level is
``VAP_LOG_LEVEL`` (INFO). Unlike JAX's, it adds no handler of its own (the
records go to the handlers the entry point configures: ``logging.basicConfig``
in ``vap_tpu_torch.train``), and it has no ``log_freq``, which nothing in
the port calls.
"""

from __future__ import annotations

import logging
import os


def process_rank() -> int:
    """This process's rank: ``torch.distributed``'s when started, else the
    launcher's ``RANK`` (0 without one)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", "0"))


class _RankFilter(logging.Filter):
    """Drops records below ERROR on ranks other than 0, unless
    ``VAP_VERBOSE_LOGS`` is set."""

    def filter(self, record: logging.LogRecord) -> bool:
        return (record.levelno >= logging.ERROR or bool(os.environ.get("VAP_VERBOSE_LOGS"))
                or process_rank() == 0)


def get_logger(name: str = "vap_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not any(isinstance(f, _RankFilter) for f in logger.filters):
        logger.addFilter(_RankFilter())
        level = os.environ.get("VAP_LOG_LEVEL", "INFO").upper()
        logger.setLevel(getattr(logging, level, logging.INFO))
    return logger
