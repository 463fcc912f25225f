"""Logging set-up: rank filtering, colour formatting, levels from the
environment (counterpart: ``automodel_tpu/loggers/log_utils.py``).

The rank is ``torch.distributed``'s when a process group is up, else 0.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import List, Optional


def _process_rank() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class RankFilter(logging.Filter):
    """Pass records only on the main process (rank 0)."""

    def __init__(self, rank: Optional[int] = None):
        super().__init__()
        self.rank = _process_rank() if rank is None else rank

    def filter(self, record: logging.LogRecord) -> bool:
        return self.rank == 0


class ColorFormatter(logging.Formatter):
    COLORS = {
        logging.DEBUG: "\x1b[38;20m",
        logging.INFO: "\x1b[32;20m",
        logging.WARNING: "\x1b[33;20m",
        logging.ERROR: "\x1b[31;20m",
        logging.CRITICAL: "\x1b[31;1m",
    }
    RESET = "\x1b[0m"

    def __init__(self, fmt: Optional[str] = None, use_color: bool = True):
        fmt = fmt or "%(asctime)s | %(levelname)-8s | %(name)s: %(message)s"
        super().__init__(fmt)
        self.use_color = use_color and sys.stderr.isatty()

    def format(self, record: logging.LogRecord) -> str:
        out = super().format(record)
        if self.use_color:
            return f"{self.COLORS.get(record.levelno, '')}{out}{self.RESET}"
        return out


def add_filter_to_all_loggers(filt: logging.Filter) -> None:
    logging.getLogger().addFilter(filt)
    for name in logging.root.manager.loggerDict:
        logging.getLogger(name).addFilter(filt)


def setup_logging(
    logging_level: Optional[int] = None,
    filter_warning: bool = True,
    modules_to_filter: Optional[List[str]] = None,
    set_level_for_all_loggers: bool = False,
    rank_filter: bool = True,
) -> None:
    """Configure root logging: the level from ``LOGGING_LEVEL`` unless
    given, warnings captured, the listed modules at WARNING, non-main
    ranks silenced."""
    if logging_level is None:
        logging_level = int(os.environ.get("LOGGING_LEVEL", logging.INFO))
    handler = logging.StreamHandler()
    handler.setFormatter(ColorFormatter())
    root = logging.getLogger()
    root.handlers.clear()
    root.addHandler(handler)
    root.setLevel(logging_level)
    if rank_filter:
        handler.addFilter(RankFilter())
    if filter_warning:
        logging.captureWarnings(True)
    for mod in modules_to_filter or []:
        logging.getLogger(mod).setLevel(logging.WARNING)
    if set_level_for_all_loggers:
        for name in logging.root.manager.loggerDict:
            logging.getLogger(name).setLevel(logging_level)
